"""The reference architecture of ``pub-minkunet42.json``: the published
MinkUNet of SPVNAS (``core/models/semantic_kitti/minkunet.py``, class
``MinkUNet``) at the configuration's widths. A stem of two K = 3
convolutions, each followed by BN and ReLU; four encoder stages, stage i
a K = 2 stride-2 convolution (BN, ReLU) from level i - 1 to i and two
residual blocks; four decoder stages, stage j a K = 2 transposed
convolution (BN, ReLU) from level 5 - j to 4 - j, its output concatenated
with the encoder's output of that level (the stem's at level 0), and two
residual blocks. A residual block is conv K3 -> BN -> ReLU -> conv K3 ->
BN, plus the shortcut (the identity, or a 1x1 convolution and BN where
the width changes), then the ReLU of the sum. No convolution has a bias."""
from perfbench.lib.reference import Layer


def layers(cfg: dict) -> list:
    cs = cfg["widths"]
    flow = dict(dataflow=cfg["dataflow"], t=cfg["t"], bias=False)
    out = []

    def blocks(stage, cin, cout, m, inp, concat=None, save=None):
        sc = inp
        if cin != cout:
            out.append(Layer(f"{stage}_proj", cin, cout, 1, m, m,
                             concat=concat, norm="bn", save=f"{stage}_sc",
                             **flow))
            sc = f"{stage}_sc"
        out.extend([
            Layer(f"{stage}_b0a", cin, cout, 3, m, m, src=inp, concat=concat,
                  norm="bn_relu", **flow),
            Layer(f"{stage}_b0b", cout, cout, 3, m, m, norm="bn", add=sc,
                  save=f"{stage}_r", **flow),
            Layer(f"{stage}_b1a", cout, cout, 3, m, m, norm="bn_relu",
                  **flow),
            Layer(f"{stage}_b1b", cout, cout, 3, m, m, norm="bn",
                  add=f"{stage}_r", save=save, **flow)])

    out += [Layer("stem0", cfg["in_channels"], cs[0], 3, 0, 0,
                  norm="bn_relu", **flow),
            Layer("stem1", cs[0], cs[0], 3, 0, 0, norm="bn_relu", save="x0",
                  **flow)]
    for i in range(1, 5):
        out.append(Layer(f"enc{i}_down", cs[i - 1], cs[i - 1], 2, i - 1, i,
                         norm="bn_relu", save=f"enc{i}_in", **flow))
        blocks(f"enc{i}", cs[i - 1], cs[i], i, f"enc{i}_in", save=f"x{i}")
    c = cs[4]
    for j in range(1, 5):
        lvl, w = 4 - j, cs[4 + j]
        out.append(Layer(f"dec{j}_up", c, w, 2, lvl + 1, lvl,
                         norm="bn_relu", transposed=True, save=f"dec{j}_in",
                         **flow))
        blocks(f"dec{j}", w + cs[lvl], w, lvl, f"dec{j}_in",
               concat=f"x{lvl}")
        c = w
    return out
