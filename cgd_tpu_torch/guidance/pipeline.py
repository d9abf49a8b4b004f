"""The CLIP guidance loss, counterpart of ``cgd_tpu/guidance/pipeline.py``:
blend x̂₀ with x by the step's ``Blend`` (fac = sqrt(1-ᾱ[ref_t])), cut out
`cutn` crops, CLIP-encode them, weighted spherical distances against the
prompt embeddings, plus the range / TV / saturation losses and, with an
init image, the LPIPS VGG distance of the blend to it times
``init_scale``. ``use_augs`` augments the cutouts before CLIP
(``cutouts.draw_augs`` then ``apply_augs``). The sampler differentiates the
returned scalar with respect to x through UNet, cutouts, CLIP and the VGG.

With a mesh the cutouts are split over every mesh device (the JAX package's
``cutout_sharding``), CLIP runs on each, and the embeddings are gathered in
cutout order; autograd sums the guidance gradient back over the devices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cgd_tpu_torch.diffusion.gaussian import PMeanVariance
from cgd_tpu_torch.diffusion.sampler import Blend, GuidanceFns, StepMeta
from cgd_tpu_torch.guidance import cutouts as _cutouts
from cgd_tpu_torch.guidance.cutouts import CutoutSpec, make_cutouts, sample_cutout_coords
from cgd_tpu_torch.guidance.losses import (
    range_loss,
    saturation_loss,
    spherical_dist_loss,
    tv_loss,
)
from cgd_tpu_torch.models.clip.configs import CLIP_MEAN, CLIP_STD, CLIPConfig
from cgd_tpu_torch.models.clip.model import CLIP, encode_image
from cgd_tpu_torch.models.vgg_lpips import VGGLPIPS, lpips_distance
from cgd_tpu_torch.parallel.mesh import Mesh, shard_params_replicated
from cgd_tpu_torch.utils.tracing import span


@dataclasses.dataclass(frozen=True)
class GuidanceSettings:
    clip_guidance_scale: float = 1000.0
    tv_scale: float = 150.0
    range_scale: float = 50.0
    sat_scale: float = 0.0
    init_scale: float = 0.0
    use_magnitude: bool = False
    use_augs: bool = False
    cutout_power: float = 1.0
    clip_compute_dtype: str = "bfloat16"


def make_guidance_builder(
    clip_model: CLIP,
    clip_cfg: CLIPConfig,
    target_embeds: torch.Tensor,  # [P, D] f32
    weights: torch.Tensor,  # [P] f32, normalized (sum |.| = 1)
    settings: GuidanceSettings,
    *,
    cached_coords: Optional[CutoutSpec] = None,
    mesh: Optional[Mesh] = None,
    lpips: Optional[VGGLPIPS] = None,
    init_image: Optional[torch.Tensor] = None,  # [B,H,W,3] in [-1, 1]
    loss_callback=None,  # fn({name: float}), called per guided step
):
    """Returns builder(meta: StepMeta) -> GuidanceFns for the sampler. With
    ``cached_coords`` every step reuses the first ``cutn`` of those cutout
    coordinates; otherwise each step draws new ones from the step's
    generator. With ``mesh`` the cutouts are encoded split over its devices
    (CLIP's image tower replicated on each distinct one). With ``lpips``
    and ``init_image`` the loss adds ``lpips_distance(lpips, x_in,
    init_image).sum() * init_scale`` ("Init VGG Loss"); the init image's VGG
    taps are computed anew every step, as in the JAX package. A
    ``loss_callback`` gets each guided step's loss scalars, then its
    gradient scalars, as floats (a device sync per step), as the JAX
    package's host callback does; such a step reads on the host
    (``GuidanceFns.host_reads``), so it is never replayed from a CUDA
    graph."""
    use_init_loss = lpips is not None and init_image is not None
    clip_size = clip_cfg.input_resolution
    device = target_embeds.device
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=device)
    compute_dtype = torch.bfloat16 if settings.clip_compute_dtype == "bfloat16" else torch.float32
    visuals = None if mesh is None else shard_params_replicated(clip_model.visual, mesh)

    tower = "vit" if clip_cfg.is_vit else "resnet"

    def encode(cuts):
        with span("guidance.clip", tower=tower, images=cuts.shape[0], resolution=clip_size):
            if mesh is None:
                return encode_image(clip_model, cuts, compute_dtype=compute_dtype)
            # cutn / mesh.size cutouts per device, in order (contiguous blocks,
            # as cutout_sharding splits the leading axis)
            parts = torch.tensor_split(cuts, mesh.size)
            return torch.cat([
                visuals[d](p.to(d).to(compute_dtype)).float().to(cuts.device)
                for p, d in zip(parts, mesh.devices.flat) if len(p)])

    def builder(meta: StepMeta) -> GuidanceFns:
        cutn = meta.cutn

        def loss_fn(x, out: PMeanVariance, blend: Blend, gen: torch.Generator):
            b, side_y, side_x = x.shape[0], x.shape[1], x.shape[2]
            x_in = out.pred_xstart * blend.fac + x * blend.rest
            if cached_coords is not None:
                spec = CutoutSpec(*(c[:cutn] for c in cached_coords))
            else:
                spec = sample_cutout_coords(
                    gen, cutn, side_x, side_y, clip_size, settings.cutout_power,
                    device=x.device)
            cuts = make_cutouts((x_in + 1.0) / 2.0, spec, clip_size)  # [K*B,c,c,3]
            if settings.use_augs:  # drawn after the coordinates, from the same generator
                cuts = _cutouts.apply_augs(cuts, _cutouts.draw_augs(gen, *cuts.shape))
            cuts = (cuts - mean) / std
            embeds = encode(cuts).reshape(cutn, b, -1)
            # [K,B,P] distances; weighted sum over prompts, mean over cutouts
            dists = spherical_dist_loss(embeds[:, :, None, :], target_embeds[None, None])
            clip_losses = (dists * weights).sum(-1).mean(0)  # [B]

            clip_total = clip_losses.sum() * settings.clip_guidance_scale
            range_total = range_loss(out.pred_xstart).sum() * settings.range_scale
            tv_total = tv_loss(x_in).sum() * settings.tv_scale
            loss = clip_total + range_total + tv_total
            log = {"CLIP Loss": clip_total, "Range Loss": range_total, "TV Loss": tv_total}
            if settings.sat_scale:
                sat_total = saturation_loss(x_in).sum() * settings.sat_scale
                log["Saturation Loss"] = sat_total
                loss = loss + sat_total
            if use_init_loss:
                init_total = lpips_distance(lpips, x_in, init_image).sum() * settings.init_scale
                log["Init VGG Loss"] = init_total
                loss = loss + init_total
            log["Total Loss"] = loss
            log = {k: v.detach() for k, v in log.items()}
            if loss_callback is not None:
                loss_callback({k: float(v) for k, v in log.items()})
            return loss, log

        def grad_transform(grad):
            log = {}
            if settings.use_magnitude:
                rms = grad.square().mean().sqrt()
                log["Magnitude"] = rms
                grad = grad * rms.clamp(max=0.05) / rms.clamp_min(1e-12)
            log["Grad"] = grad.mean()
            if loss_callback is not None:
                loss_callback({k: float(v) for k, v in log.items()})
            return grad, log

        return GuidanceFns(loss_fn, grad_transform, host_reads=loss_callback is not None)

    return builder


def normalize_weights(weights_list) -> np.ndarray:
    """Reference contract (cgd/cgd.py:100-105): raise if |sum| < 1e-3, then
    divide by |sum|."""
    w = np.asarray(weights_list, dtype=np.float32)
    total = w.sum()
    if abs(float(total)) < 1e-3:
        raise RuntimeError("The weights must not sum to 0.")
    return w / np.abs(total)
