"""MinkUNet-42 training parity with the JAX package on the CPU: one room
through plan → forward → masked cross-entropy → backward in both packages,
weights converted with ``params_from_jax``. A file of its own because the
two full-depth backward passes take about a minute here.

At random initialization the full-depth gradients are ill-conditioned in
fp32: the reference's own gradients move by up to ~25% of a tensor's
largest entry when its weights are perturbed by a few ulps (measured on
this room; BN over the few voxels of the coarse levels amplifies rounding).
No elementwise tolerance can hold two libraries' rounding to each other
there, so the parity gate is calibrated: the port's distance from the
reference must be within the reference's own distance from itself under
that perturbation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data import scenes as jscenes
from repro.models import pointcloud as jpc
from repro.train import pointcloud as jtr

from repro_torch.convert import params_from_jax
from repro_torch.models import pointcloud as tpc
from repro_torch.train import pointcloud as ttr

from test_torch_train import _grads, _tl

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

CPU = "cpu"


def _flat(tree: dict) -> np.ndarray:
    return np.concatenate([np.asarray(tree[k], np.float64).ravel()
                           for k in sorted(tree)])


def test_minkunet42_loss_and_grads_match_jax():
    """Full depth, the reference's decoder widths, one (48, 40, 24) room:
    the loss within 1e-5 relative and the head's gradient (one layer from
    the loss, well-conditioned) within 1e-3 of its largest entry; all
    parameter gradients together no farther from the reference, in
    relative L2 distance, than the reference is from itself under a 1e-6
    relative perturbation of its weights (module doc; measured 0.049
    against 0.104)."""
    make = lambda m: m.minkunet42(width=(8, 8, 8, 8), n_classes=8)
    sb = jscenes.scene_batch(seed=1, batch=1, kind="indoor",
                             extent=(48, 40, 24), labels=True, n_classes=8)
    jnet, tnet = make(jpc), make(tpc)
    jl = sb[0].layout
    jst, jlab = jtr.labeled_batch(sb, jl)
    cap = 1 << int(np.ceil(np.log2(jst.capacity)))
    jst = jst.pad_to(cap)
    jlab = jnp.concatenate([jlab, jnp.full((cap - jlab.shape[0],), -1,
                                           jlab.dtype)])
    jparams = jpc.init_pointcloud(jax.random.key(0), jnet)
    grad_fn = jax.jit(jax.value_and_grad(jtr.make_segmentation_loss_fn(
        jnet, jl), has_aux=True))
    rng = np.random.default_rng(0)
    jpert = jax.tree.map(lambda a: a * (1 + 1e-6 * jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32))), jparams)
    (jloss, _), jg = grad_fn(jparams, jst.packed, jst.features, jlab)
    _, jg_pert = grad_fn(jpert, jst.packed, jst.features, jlab)

    def named(tree):
        return {k: v.detach().numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, tree), tnet,
            device=CPU).named_parameters()}

    ref, ref_pert = named(jg), named(jg_pert)
    tst, tlab = ttr.labeled_batch(sb, _tl(jl), capacity=cap, device=CPU)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tnet,
                            device=CPU)
    loss, _, grads = _grads(ttr.make_segmentation_loss_fn(
        tnet, _tl(jl), engine="zdelta"), model, tst.packed, tst.features,
        tlab)
    got = {k: v.numpy() for k, v in grads.items()}
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    np.testing.assert_allclose(got["head"], ref["head"], rtol=0,
                               atol=1e-3 * np.abs(ref["head"]).max())
    r = _flat(ref)
    port_dist = np.linalg.norm(_flat(got) - r) / np.linalg.norm(r)
    self_dist = np.linalg.norm(_flat(ref_pert) - r) / np.linalg.norm(r)
    assert port_dist <= self_dist, (port_dist, self_dist)
