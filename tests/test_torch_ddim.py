"""The port's DDIM sampler (CogVideoX's) and the image families' timestep
shift against the JAX package: the float64 timesteps and coefficients
exactly, the step and ``add_noise`` to fp32 rounding (1e-6), a step count
that does not divide 1000, `time_shift_mu` and `calculate_mu_shift`, the
Euler grid under mu, and the Wan edit run with ``sampler="ddim"`` (a
departure: JAX's raises there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.pipeline import calculate_mu_shift as jmu
from videocof_tpu.schedulers import get_scheduler as jget
from videocof_tpu.schedulers.common import time_shift_mu as jshift
from videocof_torch.pipeline import calculate_mu_shift, latent_frame_count
from videocof_torch.schedulers import (DDIMScheduler, get_scheduler,
                                       time_shift_mu)

from _serving_pipes import J_VAE, pipelines

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("steps", [1, 3, 4, 7, 50])
def test_timesteps_and_coefficients_exact(steps):
    """7 and 3 do not divide 1000: the float stride's rounding and the
    integer previous-step offset (T // steps) must both be JAX's."""
    a, b = get_scheduler("ddim"), jget("ddim")
    np.testing.assert_array_equal(a.alphas_cumprod, b.alphas_cumprod)
    np.testing.assert_array_equal(a.set_timesteps(steps),
                                  b.set_timesteps(steps))
    np.testing.assert_array_equal(a._coeffs, b._coeffs)
    pa, pb = a.plan_arrays(), b.plan_arrays()
    assert pa["kind"] == pb["kind"] == "ddim"
    for key in ("timesteps", "c_x", "c_v"):
        np.testing.assert_array_equal(pa[key], pb[key])


@pytest.mark.parametrize("kw", [{}, {"snr_shift_scale": 1.0},
                                {"rescale_betas_zero_snr": False}])
def test_schedule_options_exact(kw):
    a, b = DDIMScheduler(**kw), jget("ddim", **kw)
    np.testing.assert_array_equal(a.alphas_cumprod, b.alphas_cumprod)


@pytest.mark.parametrize("steps", [4, 7])
def test_step_trajectory(steps):
    """A trajectory on a fixed velocity field, both samplers stepping their
    own output: within fp32 rounding."""
    a, b = get_scheduler("cogvideox_ddim"), jget("cogvideox_ddim")
    a.set_timesteps(steps)
    b.set_timesteps(steps)
    rng = np.random.default_rng(steps)
    x0 = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    w = rng.standard_normal(x0.shape).astype(np.float32)
    xa, xb = torch.from_numpy(x0), jnp.asarray(x0)
    sa, sb = a.init_state(xa), b.init_state(xb)
    for i, t in enumerate(a.timesteps):
        v = (np.tanh(xa.numpy()) * w + float(t) / 1000.0).astype(np.float32)
        xa, sa = a.step(torch.from_numpy(v), i, xa, sa)
        xb, sb = b.step(jnp.asarray(v), i, xb, sb)
        np.testing.assert_allclose(xa.numpy(), np.asarray(xb), **STEP_TOL)
        assert xa.dtype == torch.float32


@pytest.mark.parametrize("timestep", [0, 499, 999])
def test_add_noise(timestep):
    a, b = get_scheduler("ddim"), jget("ddim")
    rng = np.random.default_rng(timestep)
    x, n = (rng.standard_normal((2, 8)).astype(np.float32) for _ in range(2))
    got = a.add_noise(torch.from_numpy(x), torch.from_numpy(n), timestep)
    want = b.add_noise(jnp.asarray(x), jnp.asarray(n), timestep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)


@pytest.mark.parametrize("seq_len", [256, 1024, 4096, 4608])
def test_mu_shift(seq_len):
    assert calculate_mu_shift(seq_len) == jmu(seq_len)
    sig = np.linspace(1.0, 1e-3, 9)
    mu = calculate_mu_shift(seq_len)
    np.testing.assert_array_equal(time_shift_mu(sig, mu), jshift(sig, mu))


@pytest.mark.parametrize("steps,seq_len", [(4, 4096), (28, 4096),
                                           (30, 16)])
def test_euler_grid_under_mu(steps, seq_len):
    """The image families' Euler grid: mu from the token count."""
    a, b = get_scheduler("euler"), jget("euler")
    mu = calculate_mu_shift(seq_len)
    np.testing.assert_array_equal(a.set_timesteps(steps, mu=mu),
                                  b.set_timesteps(steps, mu=mu))
    np.testing.assert_array_equal(a.sigmas, b.sigmas)


def test_scheduler_names():
    for name in ("ddim", "cogvideox_ddim", "DDIM"):
        assert type(get_scheduler(name)).__name__ == \
            type(jget(name)).__name__ == "DDIMScheduler"


def test_departure_wan_edit_with_ddim(monkeypatch):
    """Departure: the port's `WanPipeline` runs ``sampler="ddim"``, where
    JAX's raises. JAX takes the name (`wan_pipeline.py:601-602`) but its
    stepwise loop jits ``sched.step`` with a `DDIMState`, a dataclass that
    is no pytree (TypeError), and its fused samplers have no "ddim" rule.
    With JAX's `init_state` returning None instead (an empty pytree,
    patched for this test only; the JAX package is unchanged), JAX's
    stepwise edit runs, and the port's final latents hold against it
    within 2e-4 (the pipelines' tolerance) on the same weights and noise."""
    from videocof_tpu.schedulers.ddim import DDIMScheduler as JDDIM
    monkeypatch.setenv("VIDEOCOF_FETCH_YUV420", "0")
    monkeypatch.setenv("VIDEOCOF_STEPWISE", "1")
    jpipe, pipe = pipelines()
    rng = np.random.default_rng(0)
    video = rng.integers(0, 256, (1, 3, 9, 32, 32), dtype=np.uint8)
    noise = rng.standard_normal((1, J_VAE.z_dim, latent_frame_count(9) + 1,
                                 4, 4)).astype(np.float32)
    kw = dict(source_frames=9, reasoning_frames=4, num_inference_steps=3,
              noise=noise, output_latents=True, sampler="ddim",
              guidance_scale=1.0)
    with pytest.raises(TypeError):
        jpipe(video, "remove the ball", fused_sampling=False, **kw)
    monkeypatch.setattr(JDDIM, "init_state", lambda self, latents: None)
    want = jpipe(video, "remove the ball", fused_sampling=False, **kw)
    got = pipe(video, "remove the ball", **kw)
    np.testing.assert_allclose(got.latents, want.latents, rtol=2e-4,
                               atol=2e-4)
