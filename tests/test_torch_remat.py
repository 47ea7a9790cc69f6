"""Named remat policies of the port's DiT (`wan_dit.remat_policy`, selective
activation checkpointing) against the unremat forward and full remat's
gradients, what each policy saves and recomputes (aten ops, the tagged
attention outputs, the attention forward's calls), and the policy names
JAX's `tests/test_wan_dit.py::test_remat_policy_matches` uses against the
JAX package's forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from videocof_torch import convert
from videocof_torch.configs import WanDiTConfig
from videocof_torch.models import wan_dit
from videocof_torch.ops import flash_attention as fa
from videocof_torch.training import make_lora_train_step
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import lora as jlora
from videocof_tpu.models import wan_dit as jdit

torch.set_num_threads(1)

SAVE_NAMES = "save_names:attn_out,xattn_out"
POLICIES = [False, True, "nothing_saveable", "everything_saveable",
            "dots_saveable", "checkpoint_dots",
            "dots_with_no_batch_dims_saveable",
            "checkpoint_dots_with_no_batch_dims", SAVE_NAMES]
# attention forwards (B2 on the card) per attention per step: once, and
# again in the backward's recompute under every policy that checkpoints
FORWARDS = {False: 1, "everything_saveable": 1}
LAYERS = J_WAN.num_layers


def _setup(seed=0):
    params = jdit.init_wan_dit(jax.random.PRNGKey(seed), J_WAN)
    dit = wan_dit.WanDiT(convert.config_from(WanDiTConfig, J_WAN))
    dit.load_state_dict(convert.dit_from_jax(
        jax.tree.map(np.asarray, params)))
    dit.requires_grad_(False)
    jad = jlora.init_lora_adapters(jax.random.PRNGKey(seed + 1), J_WAN,
                                   rank=4)
    rng = np.random.default_rng(seed)
    jad["blocks"] = jax.tree.map(
        lambda a: a + jnp.asarray(0.05 * rng.standard_normal(a.shape),
                                  a.dtype), jad["blocks"])
    x = rng.standard_normal((1, J_WAN.in_dim, 3, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, J_WAN.text_len, J_WAN.text_dim)
                              ).astype(np.float32)
    t = np.array([937.0], np.float32)
    cos, sin = jdit.make_rope_for_geometry(J_WAN, (3, 4, 4), f_src=1,
                                           f_ground=1)
    inputs = [np.asarray(a, np.float32) for a in (x, t, ctx, cos, sin)]
    return params, jad, dit, convert.lora_from_jax(jad, dit.cfg), inputs


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _run(dit, ad, inputs, policy, backend="flash", tags=False):
    """(output, adapter gradients) of one forward and backward."""
    dit.cfg = dit.cfg.replace(remat_tag_names=tags)
    for p in ad.parameters():
        p.grad = None
    out = dit(*(torch.from_numpy(a) for a in inputs), attn_backend=backend,
              lora=(ad, ad.scale), remat_blocks=policy)
    (out.square().mean()).backward()
    return out.detach(), [p.grad.clone() for p in ad.parameters()]


@pytest.mark.parametrize("backend", ["flash", "naive"])
@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_policy_forward_and_grads(setup, policy, backend):
    """The forward equals the unremat forward (rtol 1e-6, JAX's bound) and
    the adapter gradients equal full remat's."""
    _, _, dit, ad, inputs = setup
    want_out, _ = _run(dit, ad, inputs, False, backend)
    _, want_grads = _run(dit, ad, inputs, True, backend)
    out, grads = _run(dit, ad, inputs, policy, backend,
                      tags=policy == SAVE_NAMES)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), rtol=1e-6)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-12)


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(dit, ad, inputs, policy, tags=False):
    """Aten ops dispatched by the backward (recompute included), and the
    attention forward's calls over the whole step."""
    dit.cfg = dit.cfg.replace(remat_tag_names=tags)
    calls = []
    real = fa.flash_fwd_lse

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    fa.flash_fwd_lse = spy
    try:
        out = dit(*(torch.from_numpy(a) for a in inputs), attn_backend="flash",
                  lora=(ad, ad.scale), remat_blocks=policy)
        with _OpCounter() as counter:
            out.square().mean().backward()
    finally:
        fa.flash_fwd_lse = real
    return counter.counts, len(calls)


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_policy_saves_what_it_names(setup, policy):
    """Full remat recomputes every matmul and tag in the backward; a dots
    policy replays its matmuls from the saved outputs; 'save_names' its
    tags; no remat and 'everything_saveable' recompute nothing. The
    attention forward runs once per attention, and again in the recompute
    under every checkpointing policy (JAX recomputes its pallas_call too)."""
    _, _, dit, ad, inputs = setup
    tags = policy == SAVE_NAMES
    ops, forwards = _backward_ops(dit, ad, inputs, policy, tags)
    full, _ = _backward_ops(dit, ad, inputs, True, tags)
    plain, _ = _backward_ops(dit, ad, inputs, False, tags)
    mm = torch.ops.aten.mm.default
    addmm = torch.ops.aten.addmm.default
    tag_op = torch.ops.videocof.checkpoint_name.default
    assert forwards == FORWARDS.get(policy, 2) * 2 * LAYERS
    if policy in (False, "everything_saveable"):
        assert ops == plain
    elif policy in (True, "nothing_saveable"):
        assert ops == full
    else:
        assert ops != full
    if tags:
        assert full[tag_op] == 2 * LAYERS and tag_op not in plain
        assert tag_op not in ops            # replayed from the saved copies
    if "dots" in str(policy):
        # the linears' products come back from the cache: no addmm is
        # recomputed, and the mm left are the gradients' own
        assert addmm not in ops and full[addmm] > 0
        assert ops[mm] == plain[mm] < full[mm]


def test_lora_step_launches_per_policy(setup, monkeypatch):
    """`make_lora_train_step(remat=...)` passes the policy on: one step's
    attention forwards and backwards per policy."""
    _, _, dit, ad, inputs = setup
    counts = {"fwd": 0, "bwd": 0}
    for name, key in (("flash_fwd_lse", "fwd"), ("flash_bwd", "bwd")):
        real = getattr(fa, name)

        def spy(*args, _real=real, _key=key, **kwargs):
            counts[_key] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(fa, name, spy)
    x, t, ctx, cos, sin = (torch.from_numpy(a) for a in inputs)
    batch = {"x0": x, "context": ctx, "rope_cos": cos, "rope_sin": sin,
             "timesteps": torch.tensor([500])}
    for policy in POLICIES:
        dit.cfg = dit.cfg.replace(remat_tag_names=policy == SAVE_NAMES)
        counts.update(fwd=0, bwd=0)
        init_fn, step_fn = make_lora_train_step(dit, rank=4, remat=policy,
                                                attn_backend="flash")
        state, loss = step_fn(init_fn(torch.Generator().manual_seed(0)),
                              batch, noise=torch.zeros_like(x))
        assert np.isfinite(float(loss))
        assert counts == {"fwd": FORWARDS.get(policy, 2) * 2 * LAYERS,
                          "bwd": 2 * LAYERS}, policy


@pytest.mark.parametrize("policy", ["dots_with_no_batch_dims_saveable",
                                    SAVE_NAMES])
def test_jax_policy_names_behave_alike(setup, policy):
    """The names JAX's test uses: each side's forward under the policy
    equals its unremat forward (rtol 1e-6), and the port's equals JAX's
    (the DiT parity tolerance); the adapter gradients agree."""
    params, jad, dit, ad, inputs = setup
    tags = policy == SAVE_NAMES
    jcfg = J_WAN.replace(remat_tag_names=tags)
    jx = [jnp.asarray(a) for a in inputs]
    scale = jad["alpha"] / jad["rank"]

    def jforward(blocks, remat):
        return jdit.wan_dit_forward(params, jcfg, *jx, remat_blocks=remat,
                                    lora=(blocks, scale))

    want_plain = np.asarray(jforward(jad["blocks"], False))
    want_out = np.asarray(jforward(jad["blocks"], policy))
    np.testing.assert_allclose(want_out, want_plain, rtol=1e-6)
    want_loss, jgrads = jax.value_and_grad(
        lambda b: jnp.mean(jnp.square(jforward(b, policy))))(jad["blocks"])
    out, grads = _run(dit, ad, inputs, policy, tags=tags)
    plain, _ = _run(dit, ad, inputs, False)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(out.square().mean()), float(want_loss),
                               rtol=1e-5)
    named = dict(zip((n for n, _ in ad.named_parameters()), grads))
    gmax = max(float(g.abs().max()) for g in grads)
    for mod, names in jgrads.items():
        for name, leaf in names.items():
            for part in ("down", "up"):
                for i in range(LAYERS):
                    np.testing.assert_allclose(
                        named[f"blocks.{i}.{mod}.{name}.{part}"].numpy(),
                        np.asarray(leaf[part][i]), rtol=2e-3,
                        atol=2e-4 * gmax)


def test_unknown_policy_raises_on_both(setup):
    params, _, dit, _, inputs = setup
    with pytest.raises(ValueError):
        jdit.wan_dit_forward(params, J_WAN, *(jnp.asarray(a) for a in inputs),
                             remat_blocks="not_a_policy")
    for bad in ("not_a_policy", "save_only_these_names", 3):
        with pytest.raises(ValueError):
            with torch.no_grad():       # raised whether or not it remats
                dit(*(torch.from_numpy(a) for a in inputs),
                    remat_blocks=bad)
