"""The reference's guided sampling: guided-diffusion's linear schedule and
respacing, the ADM forward, the CLIP-guided loss of the reference
``clip-guided-diffusion`` (the blend of the denoised prediction with x,
cutouts by box filter, spherical distance, TV and range losses, the LPIPS
init loss) with its gradient taken through the UNet, and the DDIM update
with ``condition_score`` (eps' = eps - sqrt(1 - abar) grad), in float32
with TF32 off; or, where the respacing is not "ddimN", guided-diffusion's
ancestral step with ``condition_mean`` (mean + variance grad, the learned
variance interpolated between the posterior's and beta's). It draws from one ``torch.Generator`` per request in the
order the program draws: the starting noise, then per step the class
labels (``randomize_class``), the cutouts' size and offsets, the step noise.

``frames`` gives the request's saved frames (the denoised prediction at
each save point, as the uint8 image the program writes) up to a step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench_h100.reference import png
from bench_h100.reference.adm import ADMUNet
from bench_h100.reference.bpe import SimpleTokenizer
from bench_h100.reference.clip import CLIPModel
from bench_h100.reference.layers import Operands, round_outputs
from bench_h100.reference.lpips import LPIPSVGG

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


# ---------------------------------------------------------------------------
# the schedule (guided-diffusion gaussian_diffusion.py / respace.py)
# ---------------------------------------------------------------------------

def kept_timesteps(steps: int, respacing: str) -> List[int]:
    """``space_timesteps``: "ddimN" an exact integer stride, else sections."""
    if respacing.startswith("ddim"):
        n = int(respacing[4:])
        for stride in range(1, steps):
            if len(range(0, steps, stride)) == n:
                return list(range(0, steps, stride))
        raise ValueError(f"no integer stride gives {n} steps")
    counts = [int(c) for c in respacing.split(",")]
    size_per, extra, start, kept = steps // len(counts), steps % len(counts), 0, []
    for i, count in enumerate(counts):
        size = size_per + (1 if i < extra else 0)
        stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        kept += [start + round(stride * j) for j in range(count)]
        start += size
    return sorted(kept)


class Schedule:
    """The respaced linear schedule's arrays, float64 then float32."""

    def __init__(self, steps: int, respacing: str, rescale: bool):
        betas = np.linspace(1e-4 * 1000 / steps, 0.02 * 1000 / steps, steps, dtype=np.float64)
        base = np.cumprod(1.0 - betas)
        self.kept = kept_timesteps(steps, respacing)
        new_betas, last = [], 1.0
        for i in self.kept:
            new_betas.append(1.0 - base[i] / last)
            last = base[i]
        betas = np.array(new_betas)
        ac = np.cumprod(1.0 - betas)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        self.T = len(self.kept)
        self.ac, self.ac_prev = f32(ac), f32(ac_prev)
        self.log_betas = f32(np.log(betas))
        self.post_log_var = f32(np.log(np.append(post_var[1], post_var[1:])))
        self.post_c1 = f32(betas * np.sqrt(ac_prev) / (1.0 - ac))
        self.post_c2 = f32((1.0 - ac_prev) * np.sqrt(1.0 - betas) / (1.0 - ac))
        self.sqrt_ac, self.sqrt_1m_ac = f32(np.sqrt(ac)), f32(np.sqrt(1.0 - ac))
        self.sqrt_recip, self.sqrt_recipm1 = f32(np.sqrt(1.0 / ac)), f32(np.sqrt(1.0 / ac - 1))
        self.model_time = np.asarray(self.kept, np.float32) * np.float32(
            1000.0 / steps if rescale else 1.0)


# ---------------------------------------------------------------------------
# guidance pieces
# ---------------------------------------------------------------------------

def cutout_coords(gen, n: int, side_x: int, side_y: int, cut: int, power: float):
    """size = floor(u^power (max - min) + min); offsets floor(u (side - size + 1))."""
    dev = gen.device
    max_size, min_size = min(side_x, side_y), min(side_x, side_y, cut)
    u = torch.rand(n, generator=gen, device=dev)
    size = torch.floor(u ** power * (max_size - min_size) + min_size)
    ux = torch.rand(n, generator=gen, device=dev)
    uy = torch.rand(n, generator=gen, device=dev)
    return torch.floor(ux * (side_x - size + 1.0)), torch.floor(uy * (side_y - size + 1.0)), size


def _box(offset, size, n_in: int, n_out: int):
    """[K, n_out, n_in]: output bin i averages input pixels over
    [offset + i size / n_out, offset + (i + 1) size / n_out)."""
    i = torch.arange(n_out, dtype=torch.float32, device=offset.device)
    j = torch.arange(n_in, dtype=torch.float32, device=offset.device)
    scale = size[:, None] / n_out
    lo = offset[:, None] + i[None, :] * scale
    overlap = (torch.minimum((lo + scale)[:, :, None], j[None, None, :] + 1.0)
               - torch.maximum(lo[:, :, None], j[None, None, :])).clamp_min(0.0)
    return overlap / scale[:, :, None]


def cutouts(img, coords, cut: int):
    """img [B, H, W, 3] -> [K*B, 3, cut, cut], cutout-major."""
    ox, oy, size = coords
    b, h, w, _ = img.shape
    wy, wx = _box(oy, size, h, cut), _box(ox, size, w, cut)
    out = torch.einsum("kxw,kbywc->kbyxc", wx, torch.einsum("kyh,bhwc->kbywc", wy, img))
    return out.reshape(-1, cut, cut, 3).permute(0, 3, 1, 2)


def spherical_dist(x, y):
    x, y = F.normalize(x, dim=-1, eps=0.0), F.normalize(y, dim=-1, eps=0.0)
    return (x - y).norm(dim=-1).div(2).arcsin().square().mul(2)


def tv_loss(x):
    """x [B, H, W, C]: squared differences to the right and below, the last
    row and column replicated."""
    xp = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1), mode="replicate").permute(0, 2, 3, 1)
    dx = xp[:, :-1, 1:] - xp[:, :-1, :-1]
    dy = xp[:, 1:, :-1] - xp[:, :-1, :-1]
    return (dx.square() + dy.square()).mean(dim=(1, 2, 3))


def range_loss(x):
    return (x - x.clamp(-1, 1)).square().mean(dim=(1, 2, 3))


# ---------------------------------------------------------------------------
# the request
# ---------------------------------------------------------------------------

class Reference:
    """The reference models of one configuration on ``device``, from the
    published state dicts ``weights`` ({"unet": ..., "clip": ..., "lpips":
    ...} of float tensors), with every product's operands rounded by
    ``precision`` (``float32``; ``fp8`` is the control)."""

    def __init__(self, config: dict, weights: Dict[str, dict], device, precision="float32",
                 bpe_path: Optional[str] = None):
        self.cfg, self.dev = config, torch.device(device)
        ops = Operands(precision)
        with torch.device("meta"):
            unet, clip = ADMUNet(config["unet"], ops), CLIPModel(config["clip"], ops)
            lpips = LPIPSVGG(ops) if "lpips" in weights else None

        def load(model, sd):
            model.load_state_dict({k: v.to(self.dev, torch.float32) for k, v in sd.items()},
                                  strict=True, assign=True)
            return model.eval()

        self.unet, self.clip = load(unet, weights["unet"]), load(clip, weights["clip"])
        self.lpips = load(lpips, weights["lpips"]) if lpips is not None else None
        if precision != "float32":
            for model in (self.unet, self.clip, self.lpips):
                if model is not None:
                    round_outputs(model, ops)
        self.tokenizer = SimpleTokenizer(bpe_path) if bpe_path else None

    def frames(self, call: dict, until: int) -> List[Tuple[int, np.ndarray]]:
        """The frames a request of the API call ``call`` saves at steps
        0..``until``: [(step, uint8 [B, H, W, 3])]."""
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return self._frames(call, until)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    def _frames(self, call, until):
        dev, flags = self.dev, self.cfg["unet"]
        sched = Schedule(flags["diffusion_steps"], call["timestep_respacing"],
                         flags.get("rescale_timesteps", False))
        b, side, skip = call["batch_size"], call["image_size"], call.get("skip_timesteps", 0)
        cutn, cut = call["num_cutouts"], self.cfg["clip"]["vision"]["resolution"]
        gen = torch.Generator(dev).manual_seed(call["seed"])

        def arr(a):
            return torch.as_tensor(a, device=dev)

        def at(a, t):
            return arr(a)[t].reshape(1, 1, 1, 1)

        with torch.no_grad():
            tokens = self.tokenizer.tokenize(call["prompts"],
                                             context_length=self.cfg["clip"]["text"]["context_length"])
            target = self.clip.encode_text(torch.as_tensor(tokens, device=dev).long())
        weights = torch.full((len(call["prompts"]),), 1.0 / len(call["prompts"]), device=dev)
        init = None
        if call.get("init_image"):
            with open(call["init_image"], "rb") as f:
                init = arr(png.decode(f.read()).astype(np.float32) / 255.0 * 2.0 - 1.0)
            init = init[None].repeat(b, 1, 1, 1)
        clip_mean, clip_std = arr(CLIP_MEAN)[:, None, None], arr(CLIP_STD)[:, None, None]

        steps = sched.T - skip
        ddim = call["timestep_respacing"].startswith("ddim")
        x = torch.randn((b, side, side, 3), generator=gen, device=dev, dtype=torch.float32)
        if skip or init is not None:
            t0 = steps - 1
            base = init if init is not None else torch.zeros_like(x)
            x = at(sched.sqrt_ac, t0) * base + at(sched.sqrt_1m_ac, t0) * x
        y = torch.zeros((b,), dtype=torch.long, device=dev) if flags.get("class_cond") else None
        out = []
        for k in range(min(until + 1, steps)):
            t, ref_t = steps - 1 - k, sched.T - 1 - k
            if y is not None and call.get("randomize_class", True):
                y = torch.randint(0, 1000, y.shape, generator=gen, device=dev)
            tm = torch.full((b,), float(sched.model_time[t]), device=dev)
            x_ = x.detach().requires_grad_(True)
            out6 = self.unet(x_.permute(0, 3, 1, 2), tm, y).permute(0, 2, 3, 1)
            eps, var_logits = out6[..., :3], out6[..., 3:].detach()
            pred = at(sched.sqrt_recip, t) * x_ - at(sched.sqrt_recipm1, t) * eps
            if k % call["save_frequency"] == 0:
                out.append((k, png.to_uint8(pred.detach().cpu().numpy())))
            if k == until:
                break
            fac = float(sched.sqrt_1m_ac[ref_t])
            x_in = pred * fac + x_ * float(np.float32(1.0) - np.float32(fac))
            coords = cutout_coords(gen, cutn, side, side, cut, call.get("cutout_power", 1.0))
            cuts = (cutouts((x_in + 1.0) / 2.0, coords, cut) - clip_mean) / clip_std
            embeds = self.clip.visual(cuts).reshape(cutn, b, -1)
            dists = spherical_dist(embeds[:, :, None, :], target[None, None])
            loss = (dists * weights).sum(-1).mean(0).sum() * call["clip_guidance_scale"]
            loss = loss + range_loss(pred).sum() * call["range_scale"]
            loss = loss + tv_loss(x_in).sum() * call["tv_scale"]
            if init is not None and call.get("init_scale"):
                loss = loss + self.lpips(x_in.permute(0, 3, 1, 2),
                                         init.permute(0, 3, 1, 2)).sum() * call["init_scale"]
            (grad,) = torch.autograd.grad(loss, x_)
            with torch.no_grad():
                # DDIM (eta = 0) draws the step noise too and scales it by zero
                noise = torch.randn(x.shape, generator=gen, device=dev, dtype=torch.float32)
                pred = pred.detach()
                if not ddim:
                    frac = (var_logits + 1.0) / 2.0
                    log_var = frac * at(sched.log_betas, t) + (1.0 - frac) * at(sched.post_log_var, t)
                    mean = at(sched.post_c1, t) * pred + at(sched.post_c2, t) * x
                    x = mean + torch.exp(log_var) * -grad \
                        + float(t != 0) * torch.exp(0.5 * log_var) * noise
                    continue
                abar = at(sched.ac, t)
                e = (at(sched.sqrt_recip, t) * x - pred) / at(sched.sqrt_recipm1, t)
                e = e - torch.sqrt(1.0 - abar) * -grad
                pred = at(sched.sqrt_recip, t) * x - at(sched.sqrt_recipm1, t) * e
                abar_prev = at(sched.ac_prev, t)
                x = pred * torch.sqrt(abar_prev) + torch.sqrt((1.0 - abar_prev).clamp_min(0.0)) * e
        return out


def compare(program: np.ndarray, reference: np.ndarray) -> float:
    """The mean absolute difference of two uint8 frames, in units of the
    full scale (255)."""
    return float(np.abs(program.astype(np.float64) - reference.astype(np.float64)).mean() / 255.0)

