"""The reference architecture of ``repo-unet42.json``: a stem pair, four
encoder stages (a stride-2 convolution and a submanifold pair), four
decoder stages (an inverse convolution, a submanifold pair whose first
layer takes the encoder's activation of its level beside its input) and
submanifold tail layers up to the stated depth."""
from perfbench.lib.reference import Layer


def layers(cfg: dict) -> list:
    w, dw, K = cfg["width"], cfg["decoder_width"], cfg["K"]
    flow = dict(dataflow=cfg["dataflow"], t=cfg["t"])
    out = [Layer("stem0", cfg["in_channels"], w[0], K, 0, 0, save="l0",
                 **flow),
           Layer("stem1", w[0], w[0], K, 0, 0, save="l0", **flow)]
    c = w[0]
    for s, ws in enumerate(w):
        out += [Layer(f"enc{s}_down", c, ws, K, s, s + 1, **flow),
                Layer(f"enc{s}_a", ws, ws, K, s + 1, s + 1, **flow),
                Layer(f"enc{s}_b", ws, ws, K, s + 1, s + 1,
                      save=f"l{s + 1}", **flow)]
        c = ws
    for s, ws in enumerate(dw):
        lvl = len(w) - 1 - s
        skip = w[lvl - 1] if lvl > 0 else w[0]
        out += [Layer(f"dec{s}_up", c, ws, K, lvl + 1, lvl, **flow),
                Layer(f"dec{s}_a", ws + skip, ws, K, lvl, lvl,
                      concat=f"l{lvl}", **flow),
                Layer(f"dec{s}_b", ws, ws, K, lvl, lvl, **flow)]
        c = ws
    i = 0
    while len(out) < cfg["layers"]:
        out.append(Layer(f"tail{i}", c, c, K, 0, 0, **flow))
        i += 1
    return out
