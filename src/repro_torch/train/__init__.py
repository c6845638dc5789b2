"""Point-cloud training on the Spira engine (torch port of
``repro.train``): AdamW and the segmentation trainer behind
``SpiraSession.compile_train``."""
from .optimizer import (AdamWConfig, OptState, apply_updates, global_norm,
                        init_opt_state, lr_at)
from .pointcloud import (PointCloudTrainConfig, PointCloudTrainer,
                         labeled_batch, labeled_tensor,
                         make_pointcloud_train_step,
                         make_segmentation_loss_fn, scene_features,
                         scene_pool, segmentation_loss)
