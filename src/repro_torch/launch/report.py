"""The dry-run and roofline tables from a dry-run results file.

The port of ``repro/launch/report.py``, on one NVIDIA H100: "fits H100
80 GB" against the card's own ``total_memory`` when run on one, else the
data sheet's 80 GB, and the H100 constants of ``roofline`` in the footer.

  python -m repro_torch.launch.report [--json build/dryrun_results.json]
"""
from __future__ import annotations

import argparse
import json

import torch

from .. import configs
from ..configs.shapes import SHAPES
from .dryrun import RESULTS
from .roofline import HBM_BW, HBM_BYTES, LINK_BW, PEAK_FLOPS


def active_params(arch: str, n_params: int) -> float:
    """Parameters a token reads: all of a dense model's; for MoE the
    non-expert ones and ``top_k / n_experts`` of the experts'."""
    if arch not in configs.ARCHS:   # spc-* pseudo-archs: all params active
        return float(n_params)
    cfg = configs.get_config(arch)
    if cfg.n_experts:
        e_params = 0
        for sb in cfg.superblocks:
            n_moe = sum(1 for _, f in sb.blocks if f == "moe") * sb.repeat
            e_params += n_moe * cfg.n_experts * (3 * cfg.d_model
                                                 * cfg.d_ff_expert)
        frac_active = cfg.top_k / cfg.n_experts
        return n_params - e_params + e_params * frac_active
    return float(n_params)


def device_memory() -> tuple:
    """(bytes, label) of one card: the card's own when there is one, else
    the H100 data sheet's 80 GB."""
    if torch.cuda.is_available():
        return (torch.cuda.get_device_properties(0).total_memory,
                torch.cuda.get_device_name(0))
    return HBM_BYTES, "H100 80 GB (data sheet)"


def fmt_t(x: float) -> str:
    return f"{x:.3e}"


def render(res: dict) -> str:
    """The table (markdown) of every record of a results file."""
    cap, label = device_memory()
    rows = []
    for key, v in sorted(res.items()):
        if "error" in v:
            rows.append(f"| {key} | ERROR: {v['error'][:60]} |")
            continue
        mem = (v["arg_bytes_per_device"] + v["temp_bytes_per_device"]) / 2**30
        if v["shape"] in SHAPES:
            tokens = v.get("global_batch", SHAPES[v["shape"]].global_batch) \
                * (v.get("seq_len", SHAPES[v["shape"]].seq_len)
                   if v["kind"] != "decode" else 1)
            na = active_params(v["arch"], v["n_params"])
            mf = (6.0 if v["kind"] == "train" else 2.0) * na * tokens \
                / v["devices"]
            useful = f"{mf / max(v['flops_per_device'], 1):.2f}"
        else:
            useful = "—"   # point-cloud cells: MODEL_FLOPS=6ND inapplicable
        tag = v.get("tags") or ""
        fits = "✓" if mem * 2**30 <= cap else f"✗ ({mem:.0f}GiB)"
        rows.append(
            f"| {v['arch']}{'·' + tag if tag else ''} | {v['shape']} | "
            f"{v['mesh']} | "
            f"{fmt_t(v['t_compute'])} | {fmt_t(v['t_memory'])} | "
            f"{fmt_t(v['t_collective'])} | **{v['bottleneck']}** | "
            f"{useful} | {mem:.2f} | {fits} |")
    out = ["| arch | shape | mesh | t_compute (s) | t_memory (s) | "
           "t_collective (s) | bottleneck | MODEL/counted flops | "
           f"mem GiB/dev | fits {label} |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    out += rows
    out += ["", f"Constants (NVIDIA H100 SXM data sheet): peak="
            f"{PEAK_FLOPS / 1e12:.0f} TF/s bf16, HBM={HBM_BW / 1e12:.2f} "
            f"TB/s, NVLink={LINK_BW / 1e9:.0f} GB/s per direction; card "
            f"memory {cap / 1e9:.1f} GB ({label}). All terms per device "
            "(the operations each rank issues: launch/op_analysis.py)."]
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=RESULTS)
    args = ap.parse_args(argv)
    with open(args.json) as f:
        print(render(json.load(f)))


if __name__ == "__main__":
    main()
