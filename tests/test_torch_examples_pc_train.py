"""``examples/torch_train_pointcloud.py --smoke --device cpu``: 30 steps
of ``tiny_segnet`` in plain torch with the example's asserts (the loss
falls, the checkpoint round trip is bit-exact, the session serves the
trained weights); a file of its own for ``--dist loadfile``."""
from test_torch_examples import run_smoke


def test_train_pointcloud_smoke(capsys):
    out = run_smoke("torch_train_pointcloud", capsys)
    assert "params bit-exact ✓" in out and "serving trained weights" in out
