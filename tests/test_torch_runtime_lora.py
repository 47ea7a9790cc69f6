"""Runtime LoRA of the port (`models/lora.py::load_runtime_lora`,
`WanDiT.runtime_lora`, `WanPipeline.set_runtime_lora`) against the JAX
package's: two LoRA files combined by rank concatenation (a kohya file with
alpha and a PEFT file without, of other ranks and over other modules and
layers) with the non-block leftover; a forward over fp8 weights with the
runtime adapters against JAX's ``"lora__"`` forward on the same quantized
tree; the runtime adapters against merged weights; attaching to both
experts of a Wan2.2 pipeline; and `unmerge_lora`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.configs import T5_TINY as J_T5
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import lora as jlora, wan_dit as jdit
from videocof_tpu.utils import fp8 as jfp8
from videocof_torch import convert
from videocof_torch.configs import T5Config, VAE_TINY, WanDiTConfig
from videocof_torch.models import lora
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.wan_dit import WanDiT
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.pipeline import Wan22Pipeline
from videocof_torch.utils import fp8

torch.set_num_threads(1)

CFG = convert.config_from(WanDiTConfig, J_WAN)
GRID = (3, 4, 4)
FWD_REL = 1e-2      # bf16 compute over the same fp8 weights (4.1e-3)


def _files():
    """Two LoRA state dicts (numpy): a rank-4 kohya file with alpha 2 over
    every block linear of both layers and the head; a rank-3 PEFT file
    without alpha over the self-attention of layer 1, the FFN's fc1 of both
    layers and the text embedding."""
    rng = np.random.default_rng(0)
    d, f = CFG.dim, CFG.ffn_dim
    dims = {**{f"{a}.{n}": (d, d) for a in ("self_attn", "cross_attn")
               for n in "qkvo"}, "ffn.0": (d, f), "ffn.2": (f, d)}
    kohya, peft = {}, {}
    for i in range(CFG.num_layers):
        for name, (din, dout) in dims.items():
            base = "lora_unet_" + f"blocks.{i}.{name}".replace(".", "_")
            kohya[base + ".lora_down.weight"] = 0.3 * rng.standard_normal(
                (4, din))
            kohya[base + ".lora_up.weight"] = 0.3 * rng.standard_normal(
                (dout, 4))
            kohya[base + ".alpha"] = np.array(2.0)
            if name == "ffn.0" or (i == 1 and name.startswith("self_attn")):
                peft[f"blocks.{i}.{name}.lora_A.weight"] = (
                    0.3 * rng.standard_normal((3, din)))
                peft[f"blocks.{i}.{name}.lora_B.weight"] = (
                    0.3 * rng.standard_normal((dout, 3)))
    kohya["lora_unet_head_head.lora_down.weight"] = rng.standard_normal((4, d))
    kohya["lora_unet_head_head.lora_up.weight"] = rng.standard_normal((64, 4))
    peft["text_embedding.0.lora_A.weight"] = rng.standard_normal((3, 64))
    peft["text_embedding.0.lora_B.weight"] = rng.standard_normal((d, 3))
    as32 = lambda sd: {k: np.asarray(v, np.float32)  # noqa: E731
                       for k, v in sd.items()}
    return as32(kohya), as32(peft)


def _torch(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


LORAS = ((0, 0.8), (1, 1.5))     # (file index, multiplier)


def _runtime():
    files = _files()
    want, jleft = jlora.load_runtime_lora(
        [(files[i], m) for i, m in LORAS], J_WAN)
    got, left = lora.load_runtime_lora(
        [(_torch(files[i]), m) for i, m in LORAS], CFG)
    return want, jleft, got, left


def test_load_runtime_lora_matches_jax():
    want, jleft, (adapters, scale), left = _runtime()
    assert scale == want["scale"] == 1.0
    n = 0
    for mod, names in want["blocks"].items():
        for name, ad in names.items():
            for i in range(CFG.num_layers):
                lin = adapters.blocks[i][mod][name]
                np.testing.assert_array_equal(lin.down.detach().numpy(),
                                              np.asarray(ad["down"][i]))
                np.testing.assert_array_equal(lin.up.detach().numpy(),
                                              np.asarray(ad["up"][i]))
                n += 1
    assert n == 10 * CFG.num_layers
    # the concatenated rank: 4 + 3 where the PEFT file names a module
    assert adapters.blocks[0]["ffn"]["fc1"].down.shape[0] == 7
    assert adapters.blocks[0]["self_attn"]["q"].down.shape[0] == 7
    assert adapters.blocks[0]["cross_attn"]["o"].down.shape[0] == 4
    assert not adapters.blocks[0]["self_attn"]["q"].down[4:].any()
    assert set(left) == set(jleft) == {"head.head", "text_embedding.0"}
    for k in left:
        assert left[k]["multiplier"] == jleft[k]["multiplier"]
        for part in ("down", "up"):
            np.testing.assert_array_equal(left[k][part].numpy(),
                                          jleft[k][part])


def test_runtime_lora_without_block_modules():
    files = _files()
    head = {k: v for k, v in files[0].items() if "head" in k}
    got, left = lora.load_runtime_lora([(_torch(head), 1.0)], CFG)
    want, jleft = jlora.load_runtime_lora([(head, 1.0)], J_WAN)
    assert got is None and want is None and set(left) == set(jleft)


def _inputs():
    rng = np.random.default_rng(1)
    f, h, w = GRID
    x = rng.standard_normal((1, J_WAN.in_dim, f, 2 * h, 2 * w)).astype(
        np.float32)
    ctx = rng.standard_normal((1, J_WAN.text_len, J_WAN.text_dim)).astype(
        np.float32)
    cos, sin = jdit.make_rope_for_geometry(J_WAN, GRID)
    return x, ctx, cos, sin


def _port_dit(params):
    dit = WanDiT(CFG)
    dit.load_state_dict(convert.dit_from_jax(params))
    return dit


def test_runtime_forward_over_fp8_matches_jax():
    """Per-block fusion over fp8 storage, both sides from the same numpy
    quantization: relative L2 of the velocities within FWD_REL (bf16
    compute; the adapters' fp32 products sum in another order in XLA)."""
    params = jax.tree.map(np.asarray, jdit.init_wan_dit(
        jax.random.PRNGKey(0), J_WAN))
    want_rt, _, got_rt, _ = _runtime()
    q = jfp8.quantize_params_fp8(params)
    q = jax.tree.map(jnp.asarray, q)
    q["lora__"] = {"blocks": want_rt["blocks"], "scale": jnp.float32(1.0)}
    x, ctx, cos, sin = _inputs()
    want = np.asarray(jdit.wan_dit_forward(
        q, J_WAN, jnp.asarray(x), jnp.array([500.0]), jnp.asarray(ctx),
        jnp.asarray(cos), jnp.asarray(sin)))
    dit = fp8.quantize_dit_fp8(_port_dit(params))
    dit.runtime_lora = got_rt
    args = (torch.tensor(x), torch.tensor([500.0]), torch.tensor(ctx),
            torch.tensor(cos), torch.tensor(sin))
    with torch.no_grad():
        got = dit(*args).numpy()
        without = dit(*args, lora=(got_rt[0], 0.0)).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert np.isfinite(got).all() and rel <= FWD_REL, rel
    # the adapters move the output well past that tolerance
    moved = np.linalg.norm(without - want) / np.linalg.norm(want)
    assert moved > 5 * FWD_REL, (moved, rel)
    assert all(fp8.is_fp8(b.ffn.fc1) for b in dit.blocks)   # weights unmutated


def test_runtime_adapters_equal_merged_weights():
    """In fp32 the runtime adapters compute what merging the two files does
    (the same W + sum of deltas, summed in another order)."""
    params = jax.tree.map(np.asarray, jdit.init_wan_dit(
        jax.random.PRNGKey(4), J_WAN))
    _, _, runtime, _ = _runtime()
    files = _files()
    merged = _port_dit(params)
    for i, m in LORAS:
        blocks_only = {k: v for k, v in files[i].items()
                       if "head" not in k and "text_embedding" not in k}
        lora.merge_lora(merged, _torch(blocks_only), multiplier=m)
    dit = _port_dit(params)
    dit.runtime_lora = runtime
    args = [torch.tensor(a) for a in _inputs()]
    args.insert(1, torch.tensor([300.0]))
    with torch.no_grad():
        np.testing.assert_allclose(dit(*args).numpy(), merged(*args).numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_set_runtime_lora_attaches_to_both_experts():
    _, _, runtime, _ = _runtime()
    d1, d2 = WanDiT(CFG), WanDiT(CFG)
    pipe = Wan22Pipeline(d1, WanVAE(VAE_TINY),
                         T5Encoder(convert.config_from(T5Config, J_T5)),
                         device="cpu", dit_2=d2)
    pipe.set_runtime_lora(runtime)
    assert d1.runtime_lora[0] is runtime[0] and d2.runtime_lora[1] == 1.0
    pipe.set_runtime_lora(None)
    assert d1.runtime_lora is None and d2.runtime_lora is None


@pytest.mark.parametrize("multiplier", [1.0, 0.3])
def test_unmerge_lora_restores_the_weights(multiplier):
    params = jax.tree.map(np.asarray, jdit.init_wan_dit(
        jax.random.PRNGKey(5), J_WAN))
    dit = _port_dit(params)
    before = {k: v.clone() for k, v in dit.state_dict().items()}
    sd = _torch(_files()[0])
    names = lora.merge_lora(dit, sd, multiplier)
    assert lora.unmerge_lora(dit, sd, multiplier) == names
    for k, v in dit.state_dict().items():
        # each weight rounds twice in fp32 (the add, the subtract)
        np.testing.assert_allclose(v.numpy(), before[k].numpy(), rtol=0,
                                   atol=4 * np.spacing(np.float32(
                                       np.abs(before[k].numpy()).max()
                                       + 1.0)))
    # and as JAX's unmerge does
    jm = jlora.unmerge_lora(jlora.merge_lora(params, J_WAN, _files()[0],
                                             multiplier), J_WAN, _files()[0],
                            multiplier)
    for k, v in convert.dit_from_jax(jax.tree.map(np.asarray, jm)).items():
        np.testing.assert_allclose(dit.state_dict()[k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-6)
