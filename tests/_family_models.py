"""Shared pieces of the family tests (`test_torch_cogvideox.py`,
`test_torch_flux.py`, `test_torch_qwenimage.py`,
`test_torch_image_pipelines.py`, `test_torch_family_loaders.py`,
`test_torch_family_serving.py`, `test_torch_image_sp.py`): the JAX
package's tiny CogVideoX, Flux and QwenImage models and their VAEs drawn
from seeds as float32 numpy trees, the port's modules on the same weights
(carried by `videocof_torch.convert`), both packages' pipelines, and JAX's
draw of a pipeline's starting latents."""

import jax
import jax.numpy as jnp
import numpy as np

from videocof_tpu.configs import VAE_TINY as J_WAN_VAE
from videocof_tpu.models import cogvideox as jcog
from videocof_tpu.models import cogvideox_vae as jcvae
from videocof_tpu.models import flux as jflux
from videocof_tpu.models import kl_vae as jkl
from videocof_tpu.models import qwenimage as jqwen
from videocof_tpu.models import wan_vae as jwvae
from videocof_tpu.pipeline import image_pipelines as jip
from videocof_torch import convert
from videocof_torch.configs import WanVAEConfig
from videocof_torch.models import cogvideox as cog
from videocof_torch.models import cogvideox_vae as cvae
from videocof_torch.models import flux as flux_lib
from videocof_torch.models import kl_vae
from videocof_torch.models import qwenimage as qwen_lib
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.pipeline import image_pipelines as ip

# the 2B's layout (sincos, no temporal patch) and the 5B's (RoPE)
J_COG = {"2b": jcog.COGVIDEOX_TINY,
         "5b": jcog.COGVIDEOX_TINY.replace(
             use_rotary_positional_embeddings=True)}
COG = {k: cog.COGVIDEOX_TINY.replace(use_rotary_positional_embeddings=(
    k == "5b")) for k in J_COG}
# the pipelines' tiny DiTs: 2x2 packed patches of the tiny VAEs' 4 latent
# channels (KL_VAE_TINY, the Wan VAE_TINY QwenImage decodes with)
J_FLUX = {g: jflux.FLUX_TINY.replace(guidance_embeds=g, in_channels=16,
                                     out_channels=16) for g in (False, True)}
J_QWEN = jqwen.QWENIMAGE_TINY.replace(in_channels=4 * J_WAN_VAE.z_dim,
                                      out_channels=J_WAN_VAE.z_dim)
J_QVAE = J_WAN_VAE
QVAE = convert.config_from(WanVAEConfig, J_QVAE)


def f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def on_device(tree):
    return jax.tree.map(jnp.asarray, tree)


def jax_latents(seed, shape):
    """The starting latents JAX's pipelines draw."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))


# ----------------------------------------------------------------- models

def cogvideox(layout="5b", seed=0):
    """(JAX params, port `CogVideoX`) of one draw."""
    p = f32(jcog.init_cogvideox(jax.random.PRNGKey(seed), J_COG[layout]))
    m = cog.CogVideoX(COG[layout])
    m.load_state_dict(convert.cogvideox_from_jax(p))
    return p, m


def cogvideox_vae(seed=1):
    p = f32(jcvae.init_cogvideox_vae(jax.random.PRNGKey(seed),
                                     jcvae.COGVIDEOX_VAE_TINY))
    m = cvae.CogVideoXVAE(cvae.COGVIDEOX_VAE_TINY)
    m.load_state_dict(convert.cogvideox_vae_from_jax(p))
    return p, m


def flux(guidance=True, seed=0, cfg=None):
    cfg = cfg or J_FLUX[guidance]
    p = f32(jflux.init_flux(jax.random.PRNGKey(seed), cfg))
    m = flux_lib.Flux(convert.config_from(flux_lib.FluxConfig, cfg))
    m.load_state_dict(convert.flux_from_jax(p))
    return p, m


def kl(cfg=jkl.KL_VAE_TINY, seed=1):
    p = f32(jkl.init_kl_vae_decoder(jax.random.PRNGKey(seed), cfg))
    m = kl_vae.KLVAEDecoder(convert.config_from(kl_vae.KLVAEConfig, cfg))
    m.load_state_dict(convert.kl_vae_from_jax(p))
    return p, m


def qwenimage(seed=0, cfg=J_QWEN):
    p = f32(jqwen.init_qwenimage(jax.random.PRNGKey(seed), cfg))
    m = qwen_lib.QwenImage(convert.config_from(qwen_lib.QwenImageConfig,
                                               cfg))
    m.load_state_dict(convert.qwenimage_from_jax(p))
    return p, m


def qwen_vae(seed=1):
    p = f32(jwvae.init_wan_vae(jax.random.PRNGKey(seed), J_QVAE))
    m = WanVAE(QVAE)
    m.load_state_dict(convert.vae_from_jax(p))
    return p, m


# -------------------------------------------------------------- pipelines

def cog_pipelines(layout="5b"):
    dp, dit = cogvideox(layout)
    vp, vae = cogvideox_vae()
    jpipe = jip.CogVideoXPipeline(on_device(dp), J_COG[layout],
                                  on_device(vp), jcvae.COGVIDEOX_VAE_TINY)
    return jpipe, ip.CogVideoXPipeline(dit, vae, device="cpu")


def qwen_pipelines(with_vae=True):
    dp, dit = qwenimage()
    vp, vae = qwen_vae() if with_vae else (None, None)
    jpipe = jip.QwenImagePipeline(
        on_device(dp), J_QWEN,
        None if vp is None else on_device(vp),
        J_QVAE if with_vae else None)
    return jpipe, ip.QwenImagePipeline(dit, vae, device="cpu")


def flux_pipelines(guidance=True, with_vae=True):
    dp, dit = flux(guidance)
    jdecode = decode = None
    if with_vae:
        vp, vae = kl()
        jdecode = jkl.make_decode_fn(on_device(vp), jkl.KL_VAE_TINY)
        decode = kl_vae.make_decode_fn(vae)
    jpipe = jip.FluxPipeline(on_device(dp), J_FLUX[guidance],
                             decode_fn=jdecode)
    return jpipe, ip.FluxPipeline(dit, decode_fn=decode, device="cpu")


def text(seed, B, L, dim):
    return np.random.default_rng(seed).standard_normal(
        (B, L, dim)).astype(np.float32)
