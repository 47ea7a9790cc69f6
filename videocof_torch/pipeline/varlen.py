"""Ragged (mixed-length) batch editing: videos of different lengths in one
denoise batch.

Counterpart of `videocof_tpu/pipeline/varlen.py::batch_edit`. The reference
packs per-sample ``q_lens``/``k_lens`` varlen batches through FlashAttention
(`attention_utils.py:113-146`); here, as in JAX, the raggedness is data over
one padded batch:

  * each item's latents are zero-padded along latent T to the batch's
    longest;
  * each item carries its own CoF RoPE table, padded with the identity
    rotation (cos 1, sin 0), stacked to [B, L, head_dim/2];
  * ``seq_lens`` [B] becomes each row's key mask in self-attention (kernel
    B1's [B, Lk] key mask): padded tokens enter no softmax;
  * a keep mask zeroes the velocity on each item's frozen source frames and
    on its T padding, so padding stays zero through every sampler state.

Padded tokens are passengers: attention is masked, every other DiT op is
per-token and the sampler update is elementwise, so each item's valid region
is its own per-item run. The VAE encodes and decodes each item alone. JAX
refuses sequence-, tensor- and CFG-parallel pipelines here, since its varlen
step does not shard; the port has no such pipelines, so there is nothing to
refuse.

Scope: one H x W across the batch, the stepwise trajectory, optional CFG
(uncond rows first). TeaCache and cfg-skip stay per-item features.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..models import wan_dit
from ..schedulers import get_scheduler
from ..utils.profiling import spanned
from .wan_pipeline import WanPipeline, WanPipelineOutput, latent_frame_count


@torch.no_grad()
@spanned("videocof.edit")
def batch_edit(pipe: WanPipeline, videos: Sequence, source_frames: Sequence[int],
               prompt_embeds: Sequence, reasoning_frames: int = 4,
               num_inference_steps: int = 4, guidance_scale: float = 1.0,
               negative_prompt_embeds: Optional[Sequence] = None,
               shift: float = 3.0, sampler: str = "unipc",
               seeds: Optional[Sequence[int]] = None,
               solver_order: Optional[int] = None,
               output_latents: bool = False) -> List[WanPipelineOutput]:
    """Edit N videos of different lengths as one denoise batch.

    ``videos[i]`` is [3, T_i, H, W] or [1, 3, T_i, H, W] (uint8, or float in
    [-1, 1]) with one H x W for all; ``source_frames[i]`` its source span;
    ``prompt_embeds[i]`` [text_len, dim] or [1, text_len, dim]. ``seeds[i]``
    (default ``i``) draws item i's noise as ``pipe(video_i, seed=seeds[i])``
    does. Returns one ``WanPipelineOutput`` per item."""
    B = len(videos)
    if len(source_frames) != B or len(prompt_embeds) != B:
        raise ValueError(f"{B} videos, {len(source_frames)} source_frames, "
                         f"{len(prompt_embeds)} prompt_embeds")
    seeds = list(range(B)) if seeds is None else list(seeds)
    do_cfg = guidance_scale > 1.0
    if do_cfg and negative_prompt_embeds is None:
        raise ValueError("CFG needs negative_prompt_embeds per item")
    dev, dcfg = pipe.device, pipe.dit.cfg
    tc = pipe.vae.cfg.temporal_compression_ratio
    ground = latent_frame_count(reasoning_frames, tc)
    ph, pw = dcfg.patch_size[1:]

    # per item: VAE encode and noise (the per-item path), geometry, RoPE
    lats, conds, ropes, Ls = [], [], [], []
    for v, src, seed in zip(videos, source_frames, seeds):
        v = torch.as_tensor(v)
        v = pipe._prepare_video(v[None] if v.dim() == 4 else v)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        lat = pipe.prepare_cot_latents(v, ground, gen)
        cond = latent_frame_count(int(src), tc)
        Tl, Hl, Wl = lat.shape[2:]
        ropes.append(wan_dit.make_rope_for_geometry(
            dcfg, (Tl, Hl // ph, Wl // pw), f_src=cond, f_ground=ground))
        lats.append(lat)
        conds.append(cond)
        Ls.append(Tl * (Hl // ph) * (Wl // pw))

    T_max, L_max = max(lat.shape[2] for lat in lats), max(Ls)
    latents = torch.cat([F.pad(lat, (0, 0, 0, 0, 0, T_max - lat.shape[2]))
                         for lat in lats])
    cos_b = torch.stack([torch.as_tensor(np.pad(
        c, ((0, L_max - c.shape[0]), (0, 0)), constant_values=1.0))
        for c, _ in ropes]).to(dev)
    sin_b = torch.stack([torch.as_tensor(np.pad(
        s, ((0, L_max - s.shape[0]), (0, 0)))) for _, s in ropes]).to(dev)
    seq_lens = torch.tensor(Ls, dtype=torch.int32, device=dev)

    # velocity keep mask: 0 on each item's frozen source frames and on its T
    # padding (the padding stays zero through the whole trajectory)
    fidx = torch.arange(T_max, device=dev)[None]
    keep = ((fidx >= torch.tensor(conds, device=dev)[:, None])
            & (fidx < torch.tensor([lat.shape[2] for lat in lats],
                                   device=dev)[:, None]))
    keep = keep.float()[:, None, :, None, None]

    def stack(embeds):
        return torch.cat([torch.as_tensor(e).reshape(1, *e.shape[-2:])
                          for e in embeds]).to(dev, pipe.dtype)

    context = stack(prompt_embeds)
    if do_cfg:   # uncond rows first, and the per-item tables with them
        context = torch.cat([stack(negative_prompt_embeds), context])
        cos_b, sin_b = torch.cat([cos_b, cos_b]), torch.cat([sin_b, sin_b])
        seq_lens = torch.cat([seq_lens, seq_lens])

    sched_kw = ({"solver_order": solver_order} if solver_order is not None
                and sampler in ("unipc", "dpm++") else {})
    sched = get_scheduler(sampler, **sched_kw)
    sched.set_timesteps(num_inference_steps, shift=shift)
    state = sched.init_state(latents)
    if pipe.sp_ctx is not None:
        # JAX's guard: the ragged step does not shard its tokens, so a
        # parallel backend would see the whole stream
        raise NotImplementedError(
            "varlen.batch_edit does not compose with sequence/cfg-parallel "
            "pipelines; disable_sequence_parallel() first")
    for i in range(num_inference_steps):
        x = torch.cat([latents, latents]) if do_cfg else latents
        t = torch.full((x.shape[0],), float(sched.timesteps[i]),
                       dtype=torch.float32, device=dev)
        v = pipe.dit(x.to(pipe.dtype), t, context, cos_b, sin_b,
                     attn_backend=pipe.attn_backend, seq_lens=seq_lens)
        if do_cfg:
            vu, vc = v.chunk(2)
            v = vu + guidance_scale * (vc - vu)
        latents, state = sched.step(v * keep, i, latents, state)

    # per item: decode its valid region
    outs = []
    for i, lat in enumerate(lats):
        lat_i = latents[i:i + 1, :, :lat.shape[2]]
        out = pipe._decode_outputs(lat_i, conds[i], ground)
        if output_latents:
            out.latents = lat_i.cpu().numpy()
        outs.append(out)
    return outs
