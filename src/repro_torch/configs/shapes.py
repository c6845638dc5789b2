"""Assigned input shapes (one set shared by all LM-family archs).

``train_*`` lowers train_step; ``prefill_*`` lowers the prefill path;
``decode_*`` / ``long_*`` lower serve (decode) steps with a KV/state cache of
the given length. ``long_500k`` requires sub-quadratic sequence mixing and
only runs for archs with ``subquadratic=True`` (see DESIGN.md §4 skips).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable(cfg, shape: ShapeSpec) -> bool:
    if shape.name == "long_500k":
        return bool(cfg.subquadratic)
    return True
