"""Quickstart on the PyTorch port: the Spira engine on one sparse-conv layer
(``examples/quickstart.py`` on ``repro_torch``).

Builds a synthetic indoor scene, packs coordinates once, constructs the
kernel map with the one-shot z-delta search, inspects the L1-density
property, and runs all three feature-computation dataflows — asserting they
agree with each other (the paper's Fig. 5 machinery in ~40 lines). On the
card OS and WS run the hand-written kernels (``csrc/spconv_gather_gemm.cu``,
``csrc/ws_scatter_gemm.cu``); the one-layer search is the z-delta search
in torch (the superwindow kernel serves the network plan).

Run:  PYTHONPATH=src python examples/torch_quickstart.py
      [--device cuda|cpu]      (cuda by default; there is no fallback)

``--smoke`` is accepted, as by every example, and changes nothing: the
example is CI-sized already.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (KernelMap, build_coord_set, density_by_l1,
                              hybrid, output_stationary, weight_stationary,
                              zdelta_offsets, zdelta_search)
from repro_torch.data import scenes

K, CIN, COUT = 5, 16, 32
ROOM = (120, 96, 40)


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="accepted; the example is CI-sized already")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to run on the CPU)")
    return args


def kernel_map(scene, device: str) -> KernelMap:
    """Pack once (the only packing the whole network ever does), one sort,
    then the one-shot z-delta search: |Vq|·K² anchor searches."""
    packed = scenes.pack_scene(scene, device=device)
    coords = build_coord_set(packed)
    _, anchors, zstep = zdelta_offsets(K, 1, scene.layout, device=device)
    m = zdelta_search(coords, coords, anchors, zstep, K=K)
    return KernelMap(m=m, out_count=coords.count, in_count=coords.count)


def dataflows(kmap: KernelMap, feats: torch.Tensor, w: torch.Tensor):
    """The three dataflows on one layer: (OS, WS, hybrid at t = 3) outputs
    and the WS capacity (the largest column plus 8: lossless)."""
    cap = int(kmap.column_counts().max()) + 8
    out_os = output_stationary(feats, kmap.m, w)
    out_ws = weight_stationary(feats, kmap.m, w, capacity=cap)
    out_hy = hybrid(feats, kmap, w, K=K, stride=1, t=3, ws_capacity=cap)
    return out_os, out_ws, out_hy, cap


def main(argv=None) -> None:
    args = parse(argv)
    dev = args.device

    # 1. a voxelized scene (surfaces, so the density property holds)
    scene = scenes.indoor_scene(seed=0, room=ROOM)
    print(f"scene: {len(scene.coords)} voxels, layout "
          f"{scene.layout.bx}/{scene.layout.by}/{scene.layout.bz} bits")

    # 2-3. pack once + single sort, one-shot z-delta kernel map
    kmap = kernel_map(scene, dev)

    # 4. the L1-norm density property (paper Fig. 3b)
    print("kernel-map column density by offset L1 norm:")
    for l1, d in density_by_l1(kmap, K, 1).items():
        print(f"  L1={l1}: {d:6.1%}")

    # 5. feature computation, three dataflows
    gen = torch.Generator(device=dev)
    feats = torch.randn((kmap.m.shape[0], CIN), generator=gen.manual_seed(0),
                        device=dev)
    w = torch.randn((K ** 3, CIN, COUT), generator=gen.manual_seed(1),
                    device=dev) * 0.05
    out_os, out_ws, out_hy, _ = dataflows(kmap, feats, w)
    np.testing.assert_allclose(out_os.cpu(), out_ws.cpu(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(out_os.cpu(), out_hy.cpu(), rtol=2e-4,
                               atol=2e-5)
    where = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    print(f"all dataflows agree; output {tuple(out_os.shape)}, "
          f"t=3 hybrid splits offsets dense/sparse by L1 norm ✓ ({where})")


if __name__ == "__main__":
    main()
