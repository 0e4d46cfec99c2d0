"""The remat policies against the JAX package's ``jax.checkpoint``
policies: every argument-free ``jax.checkpoint_policies`` name is taken
(any other raises), each gives the loss and gradients of remat off, and
the products a selective policy saves in a dense block and in a Mamba2
block are the residuals ``jax._src.ad_checkpoint.saved_residuals`` lists
for the same policy.

Tolerances: none. Remat recomputes the same ops on the same tensors, so
losses and gradients are compared bitwise. Saved products are compared as
a multiset of shapes, each shape's dims sorted (``torch.einsum``'s
product is laid out in the output's order, JAX's ``dot_general`` in its
own: (batch, lhs free, rhs free)). Two differences are by design and
taken out before the comparison: the port's policy keeps the block's
last product (the block's output, which the backward pass does not read,
so JAX lists no residual for it), and the reference's Mamba2 chunk scan
runs in ``jnp`` inside the block, where the port runs it as its SSD
kernel op, which is not a product (as a ``pallas_call`` is not one): the
scan's own residuals (``closed_call``) are left out of the JAX list."""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals

import repro.configs as jax_configs
from repro.models import api as jax_api
from repro.models import hybrid as jax_hybrid
from repro.models import params as jax_params_lib
from repro.models import transformer as jax_transformer
from repro.models.transformer import StepConfig as JaxStepConfig
from repro_torch import configs
from repro_torch.models import api, hybrid, remat, transformer
from repro_torch.models.params import flatten, materialize
from repro_torch.models.transformer import StepConfig

NAMES = ["nothing_saveable", "everything_saveable", "dots_saveable",
         "checkpoint_dots", "dots_with_no_batch_dims_saveable",
         "checkpoint_dots_with_no_batch_dims"]


def test_every_argument_free_jax_policy_is_taken():
    import inspect
    # a policy is called with (prim, *args, **params); a factory takes
    # names or policies and has no **params
    free = sorted(n for n in dir(jax.checkpoint_policies)
                  if not n.startswith("_") and any(
                      p.kind == p.VAR_KEYWORD for p in inspect.signature(
                          getattr(jax.checkpoint_policies, n)).parameters
                      .values()))
    assert free == sorted(NAMES)
    for name in NAMES:
        assert StepConfig(remat_policy=name).policy() == name
    assert StepConfig(remat=False).policy() is None
    with pytest.raises(ValueError, match="dots_saveable"):
        StepConfig(remat_policy="save_only_these_names")


def _loss_and_grads(arch, step):
    cfg = configs.get_smoke(arch)
    params = materialize(torch.Generator().manual_seed(0),
                         api.param_defs(cfg))
    tokens = torch.from_numpy(
        __import__("numpy").random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 16)))
    return api.loss_and_grads(params, {"tokens": tokens}, cfg, step)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("arch", ["granite_3_2b", "mamba2_130m"])
def test_policy_gives_the_loss_and_gradients_of_remat_off(arch, name):
    want_loss, want = _loss_and_grads(arch, StepConfig(remat=False,
                                                       loss_chunk=8))
    loss, grads = _loss_and_grads(arch, StepConfig(remat=True,
                                                   remat_policy=name,
                                                   loss_chunk=8))
    assert torch.equal(loss, want_loss)
    got, exp = flatten(grads), flatten(want)
    assert all(torch.equal(got[k], exp[k]) for k in exp)


def _port_saved(fn, args, name, monkeypatch):
    """Shapes of the products the port's policy saves in one call (first
    pass only, not the backward's recompute)."""
    from repro_torch.models.dots import current_dot
    saved = []
    real = remat.policy_fn

    def recording(policy_name):
        policy = real(policy_name)

        def wrapped(ctx, op, *a, **kw):
            out = policy(ctx, op, *a, **kw)
            if out.name == "MUST_SAVE" and not ctx.is_recompute:
                saved.append(current_dot()[1])
            return out
        return wrapped

    monkeypatch.setattr(remat, "policy_fn", recording)
    leaves = [t.detach().requires_grad_() for t in args]
    out = remat.remat(fn, name)(*leaves)
    out.float().sum().backward()
    return saved


def _jax_saved(fn, args, name, drop=()):
    res = saved_residuals(jax.checkpoint(
        fn, policy=getattr(jax.checkpoint_policies, name)), *args)
    return [tuple(a.shape) for a, src in res
            if "argument" not in src and "from a constant" not in src
            and not any(d in src for d in drop)]


def _canon(shapes):
    return sorted(tuple(sorted(s)) for s in shapes)


BLOCKS = {
    "dense": ("granite_3_2b",
              lambda cfg: lambda h, *lp: transformer._self_block(
                  h, _unflat(lp), cfg, StepConfig()),
              lambda cfg: lambda h, lp: jax_transformer._self_block(
                  h, lp, cfg, JaxStepConfig()), ()),
    "mamba": ("mamba2_130m",
              lambda cfg: lambda h, *lp: hybrid._mamba_block(
                  h, _unflat(lp), cfg)[0],
              lambda cfg: lambda h, lp: jax_hybrid._mamba_block(
                  h, lp, cfg)[0], ("closed_call",)),
}
_KEYS: list = []


def _unflat(leaves):
    from repro_torch.models.params import unflatten
    return unflatten(dict(zip(_KEYS, leaves)))


@pytest.mark.parametrize("name", ["dots_saveable",
                                  "dots_with_no_batch_dims_saveable"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_saved_products_are_the_references_residuals(block, name,
                                                     monkeypatch):
    arch, port_fn, jax_fn, drop = BLOCKS[block]
    cfg, jcfg = configs.get_smoke(arch), jax_configs.get_smoke(arch)
    lp = {k: v[0] for k, v in flatten(materialize(
        torch.Generator().manual_seed(0), api.param_defs(cfg))[
            "layers"]).items()}
    _KEYS[:] = list(lp)
    h = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2)).to(cfg.tdtype)
    port = _port_saved(port_fn(cfg), [h, *lp.values()], name, monkeypatch)
    jlp = jax.tree.map(lambda x: x[0], jax_params_lib.materialize(
        jax.random.key(0), jax_api.param_defs(jcfg))["layers"])
    want = _jax_saved(jax_fn(jcfg), (jnp.ones((2, 16, jcfg.d_model),
                                              jcfg.jdtype), jlp), name,
                      drop)
    # the block's output is its last product (dense: the MLP's down
    # projection; Mamba2: the out projection); JAX lists no residual
    # for it
    assert port[-1] == (2, 16, cfg.d_model)
    assert _canon(port[:-1]) == _canon(want)
