"""``examples/torch_pointcloud_inference.py --smoke --device cpu``:
MinkUNet-42 at full width on two indoor (48, 40, 24) scenes in plain
torch, scene 0 alone and the batch, each twice, with the example's
batched-vs-single bitwise assert (``tests/test_torch_examples.py`` has the
other examples; this one is a file of its own for ``--dist loadfile``)."""
from test_torch_examples import run_smoke


def test_pointcloud_inference_smoke(capsys):
    out = run_smoke("torch_pointcloud_inference", capsys)
    assert "single-scene logits (bitwise) ✓, finite=True on cpu" in out
