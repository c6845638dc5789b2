"""Training on the port (torch port of ``repro.train``): AdamW, the LM
training step and loop (``loop``, with gradient compression), the
point-cloud segmentation trainer and the self-healing trainer behind
``SpiraSession.compile_train``."""
from .guard import (GuardConfig, GuardedPointCloudTrainer, LossSpikeDetector,
                    TrainAbortError, TrainHealthReport, checkpoint_trees,
                    guarded_apply_updates, make_guarded_train_step)
from .loop import (PreemptionGuard, TrainConfig, make_train_step, step_leaves,
                   train)
from .optimizer import (AdamWConfig, OptState, StagedUpdate, apply_updates,
                        apply_updates_parts, global_norm, init_opt_state,
                        lr_at, stage_updates)
from .pointcloud import (PointCloudTrainConfig, PointCloudTrainer,
                         labeled_batch, labeled_tensor,
                         make_grad_fn, make_pointcloud_train_step,
                         make_segmentation_loss_fn, scene_features,
                         read_metrics, scene_pool, segmentation_loss)
from . import compression, loop
