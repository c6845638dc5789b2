"""The reference architecture of ``repo-resnl20.json``: a K = 5 stem,
four stages (a K = 3 stride-2 convolution from the second on, then a
submanifold K = 5 pair) and submanifold K = 5 layers at the coarsest level
up to the stated depth. The stride-2 convolutions take the hybrid split at
t = 0 (every offset weight-stationary), the others at the stated t."""
from perfbench.lib.reference import Layer


def layers(cfg: dict) -> list:
    w, K, flow, t = cfg["width"], cfg["K"], cfg["dataflow"], cfg["t"]
    out = [Layer("stem", cfg["in_channels"], w[0], K, 0, 0, dataflow=flow,
                 t=t)]
    c = w[0]
    for s, ws in enumerate(w):
        if s > 0:
            out.append(Layer(f"s{s}_down", c, ws, 3, s - 1, s, dataflow=flow,
                             t=0))
            c = ws
        out += [Layer(f"s{s}_b0a", c, ws, K, s, s, dataflow=flow, t=t),
                Layer(f"s{s}_b0b", ws, ws, K, s, s, dataflow=flow, t=t)]
        c = ws
    top = len(w) - 1
    while len(out) < cfg["layers"]:
        out.append(Layer(f"head{len(out)}", c, c, K, top, top, dataflow=flow,
                         t=t))
    return out
