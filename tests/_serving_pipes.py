"""Shared pieces of the serving tests (`test_torch_serving.py`,
`test_torch_serving_http.py`): the tiny JAX and port pipelines on the same
weights (carried by `videocof_torch.convert`), with one expert or two, in
fp32 or with fp8 experts; LoRA files; a cv2 clip; the injection of the same
noise into both packages' pipelines; and the comparison of a port DiT with
a JAX param tree."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from videocof_tpu.configs import T5_TINY as J_T5, VAE_TINY as J_VAE
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import t5_encoder as jt5, wan_dit as jdit
from videocof_tpu.models import wan_vae as jvae
from videocof_tpu.pipeline import Wan22Pipeline as JaxWan22
from videocof_tpu.pipeline import WanPipeline as JaxWan
from videocof_tpu.utils.fp8 import quantize_params_fp8
from videocof_torch import convert
from videocof_torch.configs import T5Config, WanDiTConfig, WanVAEConfig
from videocof_torch.models.t5_encoder import T5Encoder, init_t5_encoder
from videocof_torch.models.wan_dit import WanDiT, init_wan_dit
from videocof_torch.models.wan_vae import WanVAE, init_wan_vae
from videocof_torch.pipeline import Wan22Pipeline, WanPipeline
from videocof_torch.utils import checkpoint
from videocof_torch.utils.fp8 import is_fp8, quantize_dit_fp8

DCFG = J_WAN.replace(in_dim=J_VAE.z_dim, out_dim=J_VAE.z_dim,
                     text_dim=J_T5.dim)
TDCFG = convert.config_from(WanDiTConfig, DCFG)
TVCFG = convert.config_from(WanVAEConfig, J_VAE)
TT5CFG = convert.config_from(T5Config, J_T5)
FRAMES, SIZE = 9, 32            # the clips: 9 frames of 32 x 32
# the edit's latent noise: 3 condition + 1 ground + 3 target latent frames
EDIT_NOISE_SHAPE = (1, J_VAE.z_dim, 4, SIZE // 8, SIZE // 8)


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def port_dit(params) -> WanDiT:
    dit = WanDiT(TDCFG)
    dit.load_state_dict(convert.dit_from_jax(as_np(params)))
    return dit


def pipelines(moe=False, fp8=False, seed=0):
    """(JAX pipeline, port pipeline) in fp32 on the same tiny weights; with
    ``moe`` a Wan2.2 pair (boundary 0.9), with ``fp8`` every expert stored
    in fp8 (JAX's numpy quantization, the port's `quantize_dit_fp8`)."""
    dps = [jdit.init_wan_dit(jax.random.PRNGKey(seed + k), DCFG)
           for k in ((0, 4) if moe else (0,))]
    vp = jvae.init_wan_vae(jax.random.PRNGKey(seed + 1), J_VAE)
    tp = jt5.init_t5_encoder(jax.random.PRNGKey(seed + 2), J_T5)
    dits = [port_dit(p) for p in dps]
    if fp8:
        dps = [jax.tree.map(jnp.asarray, quantize_params_fp8(as_np(p)))
               for p in dps]
        dits = [quantize_dit_fp8(d) for d in dits]
    vae = WanVAE(TVCFG)
    vae.load_state_dict(convert.vae_from_jax(as_np(vp)))
    t5 = T5Encoder(TT5CFG)
    t5.load_state_dict(convert.t5_from_jax(as_np(tp)))
    jkw = dict(dtype=jnp.float32)
    kw = dict(dtype=torch.float32, device="cpu")
    if moe:
        return (JaxWan22(dps[0], DCFG, vp, J_VAE, tp, J_T5,
                         dit_params_2=dps[1], boundary=0.9, **jkw),
                Wan22Pipeline(dits[0], vae, t5, dit_2=dits[1], boundary=0.9,
                              **kw))
    return (JaxWan(dps[0], DCFG, vp, J_VAE, tp, J_T5, **jkw),
            WanPipeline(dits[0], vae, t5, **kw))


def port_pipeline(seed=0) -> WanPipeline:
    """A tiny port pipeline in fp32 on the CPU, drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return WanPipeline(init_wan_dit(TDCFG, gen), init_wan_vae(TVCFG, gen),
                       init_t5_encoder(TT5CFG, gen), dtype=torch.float32,
                       device="cpu")


def inject(pipe, noise, outputs, t2v_noise=None, **extra):
    """Make every edit of ``pipe`` take ``noise`` (and every text-to-video
    call ``t2v_noise``, default ``noise``) and keep its output, with the
    final latents, in ``outputs``; ``extra`` reaches every call (JAX:
    ``fused_sampling=False``). The instance keeps its class's behaviour
    and type checks (a subclass is swapped in)."""
    base = type(pipe)
    t2v_noise = noise if t2v_noise is None else t2v_noise

    class Injected(base):
        def __call__(self, *a, **kw):
            out = base.__call__(self, *a, noise=noise, output_latents=True,
                                **extra, **kw)
            outputs.append(out)
            return out

        def text_to_video(self, *a, **kw):
            out = base.text_to_video(self, *a, noise=t2v_noise,
                                     output_latents=True, **extra, **kw)
            outputs.append(out)
            return out

    pipe.__class__ = Injected
    return pipe


def lora_file(path, seed, fmt="kohya", rank=2, head=False):
    """A LoRA file over every block linear of the tiny DiT: kohya
    (``lora_unet_*`` with alpha 1) or PEFT (``lora_A``/``lora_B``, no
    alpha); ``head`` adds the head linear, a module outside the blocks."""
    rng = np.random.default_rng(seed)
    d, f = TDCFG.dim, TDCFG.ffn_dim
    dims = {**{f"{a}.{n}": (d, d) for a in ("self_attn", "cross_attn")
               for n in "qkvo"}, "ffn.0": (d, f), "ffn.2": (f, d)}
    names = [(f"blocks.{i}.{n}", dd) for i in range(TDCFG.num_layers)
             for n, dd in dims.items()]
    if head:
        names.append(("head.head", (d, TDCFG.out_dim * 4)))
    sd = {}
    for name, (din, dout) in names:
        down = 0.1 * rng.standard_normal((rank, din))
        up = 0.1 * rng.standard_normal((dout, rank))
        if fmt == "kohya":
            base = "lora_unet_" + name.replace(".", "_")
            sd[base + ".lora_down.weight"] = down
            sd[base + ".lora_up.weight"] = up
            sd[base + ".alpha"] = np.array(1.0)
        else:
            sd[f"{name}.lora_A.weight"] = down
            sd[f"{name}.lora_B.weight"] = up
    checkpoint.write_safetensors(path, {
        k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()})
    return path


def write_clip(path, frames=FRAMES, seed=0):
    """A random mp4v clip of ``frames`` frames of SIZE x SIZE (cv2)."""
    import cv2
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (SIZE, SIZE))
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        w.write(rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8))
    w.release()
    return str(path)


def assert_dit_matches(dit, params, atol=0.0):
    """``dit``'s weights equal (within ``atol``) JAX's fp32 param tree."""
    want = convert.dit_from_jax(as_np(params))
    got = dit.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=atol, err_msg=k)


def assert_fp8_matches(dit, qtree):
    """Every fp8 linear of ``dit`` equal bit for bit, in fp8 bits and
    scale, to JAX's quantized tree, and the other linears unquantized on
    both sides."""
    seen = 0
    for name, mod in dit.named_modules():
        if not isinstance(mod, torch.nn.Linear):
            continue
        path = convert.jax_param_path(name + ".weight").split("/")
        node = qtree
        for p in path:
            node = node[p]
        assert is_fp8(mod) == isinstance(node, dict), name
        if not is_fp8(mod):
            continue
        q, s = np.asarray(node["fp8"]), np.asarray(node["scale"], np.float32)
        if path[0] == "blocks":
            i = int(name.split(".")[1])
            q, s = q[i], s[i]
        np.testing.assert_array_equal(mod.weight.view(torch.uint8).numpy(),
                                      np.swapaxes(q, -1, -2).view(np.uint8))
        assert mod.weight_scale.numpy().tobytes() == s.tobytes(), name
        seen += 1
    assert seen == 4 + 10 * TDCFG.num_layers
