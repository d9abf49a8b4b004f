"""The guided step of the ``acc512`` cell's configuration at its published
widths on the card (``bench_h100/configs/adm512c-rn50x16.json``: OpenAI's
512px class-conditional ADM, CLIP RN50x16 at 384px, bf16): the port through
``api.clip_guided_diffusion`` as the benchmark drives it (the cell's call,
``weights_mode="auto"`` over the seeded caches) against the benchmark's
plain float32 reference (``bench_h100/reference``, TF32 off) on the same
published weights and generator draws, at step 0.

Held, first: the gradient of the CLIP loss with respect to the blended
image ``(x_in + 1) / 2`` that the cutouts are cut from, through the 16
cutouts of 384^2, the RN50x16 tower (127 convs, the 48-head attention pool)
and the spherical distances. Each side computes it at the same image, the
float32 reference's own: the port's and the control's cutout functions are
handed that image's values, their gradients flowing back as before. Held,
second: the whole step-0 guidance gradient with respect to x of those same
runs, which adds the blend, the TV and range losses and the UNet's
backward. Both as cosine similarity and relative L2. The control is the
reference with every product's operands in fp8 e4m3
(``reference/layers.py``).

The readings (H100 80GB HBM3, 700 W; seeds 2300000501 / 502): the CLIP
gradient in bf16 cosine 0.9861 / 0.9869, relative L2 0.1669 / 0.1617, the
control 0.7382 / 0.7274 and 0.6904 / 0.7781; the limits 0.95 and 0.3 leave
the port 1.8x of room in relative L2 and the control fails both. The whole
gradient in bf16 0.9264 / 0.9867 and 0.4704 / 0.1754, the control
0.1683 / 0.0536 and 58.90 / 18.29: at t = 999 the prediction is
sqrt(1/abar) x - sqrt(1/abar - 1) eps with both factors near 156 and eps
near x, so the rounding of eps and of the UNet's backward reaches the
gradient some 156-fold; the limits 0.7 and 1.5 leave bf16 3x of room in
relative L2 and sit an order of magnitude under the control. Left to
itself (its own image, not the reference's), the port's whole gradient
read 0.229 / 0.974 against the reference's in bf16 on one of the seeds
(the other not recorded): the image that same
156-fold rounding moves is what the tower sees, and the tower's gradient
at two such images differs.

Marked ``cuda``; imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_port_adm512c_cuda.py -s
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (2300000501, 2300000502)
COS_MIN, REL_MAX = 0.95, 0.3  # the CLIP loss's gradient at a shared image
WHOLE_COS_MIN, WHOLE_REL_MAX = 0.7, 1.5  # the whole guidance gradient with respect to x


def _grads(monkeypatch):
    """Records each ``torch.autograd.grad`` result taken with respect to one
    NHWC image tensor (a step's guidance gradient)."""
    seen = []
    grad = torch.autograd.grad

    def recording(outputs, inputs, *a, **k):
        out = grad(outputs, inputs, *a, **k)
        if isinstance(inputs, torch.Tensor) and inputs.dim() == 4 and inputs.shape[-1] == 3:
            seen.append(out[0].detach().float().clone())
        return out

    monkeypatch.setattr(torch.autograd, "grad", recording)
    return seen


def _cutout_grads(monkeypatch, module, name, shared=None):
    """Wraps the cutout function ``module.name`` (the image first): each call
    records its image and, once the backward reaches it, the gradient with
    respect to it. With ``shared`` the image takes ``shared``'s values, its
    gradient still flowing back to the caller's image."""
    seen = []
    cut = getattr(module, name)

    def wrapped(img, *a, **k):
        if shared is not None:
            img = img + (shared.to(img.dtype) - img).detach()
        rec = {"img": img.detach().clone()}
        img.register_hook(lambda g: rec.__setitem__("grad", g.detach().float().clone()))
        seen.append(rec)
        return cut(img, *a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return seen


def _against(got, want):
    cos = float((got * want).sum() / (got.norm() * want.norm()))
    return cos, float((got - want).norm() / want.norm())


def readings(monkeypatch, config, weights, bpe, call, device):
    """Step 0 of ``call`` through the port's API and the reference in
    float32 and in fp8: {side: (CLIP-loss gradient with respect to the
    cutouts' image, whole guidance gradient with respect to x)}; the port's
    and the fp8 reference's at the float32 reference's image."""
    from bench_h100.reference import sampling
    from bench_h100.reference.sampling import Reference
    from cgd_tpu_torch import api
    from cgd_tpu_torch import weights as tweights
    from cgd_tpu_torch.guidance import pipeline

    out = {}

    def reference(precision, shared):
        with monkeypatch.context() as m:
            grads = _grads(m)
            cuts = _cutout_grads(m, sampling, "cutouts", shared)
            Reference(config, weights, device, precision, bpe).frames(call, 1)
        return cuts[0], grads[0]

    ref_cut, ref_grad = reference("float32", None)
    out["float32"] = (ref_cut["grad"], ref_grad)
    shared = ref_cut["img"]
    with monkeypatch.context() as m:
        grads = _grads(m)
        cuts = _cutout_grads(m, pipeline, "make_cutouts", shared)
        gen = api.clip_guided_diffusion(**call, weights_mode="auto", device=device,
                                        progress=False)
        try:
            next(gen)  # step 0's frame: its gradient has been taken
        finally:
            gen.close()
            tweights.clear_model_cache()
    out["port"] = (cuts[0]["grad"], grads[0])
    cut, grad = reference("fp8", shared)
    out["fp8"] = (cut["grad"], grad)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_the_step0_clip_gradient_at_published_widths(seed, tmp_path, monkeypatch, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's kernels have no CPU mode")
    from bench_h100.harness import window
    from bench_h100.harness.cells import Cell
    from cgd_tpu_torch.io_utils import download
    from cgd_tpu_torch.models.clip import tokenizer as ttok

    dev = torch.device("cuda")
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setattr(download, "CACHE_PATH", str(home / ".cache" / "clip-guided-diffusion"))
    monkeypatch.setattr(ttok, "_DEFAULT_TOKENIZER", None)
    monkeypatch.chdir(tmp_path)
    cell = Cell(ROOT, "acc512")
    weights, bpe, _, _ = window.prepare(cell, seed, str(tmp_path), dev)
    call = next(window.request_calls(cell, seed, str(tmp_path), None))
    got = readings(monkeypatch, cell.config, window.reference_weights(weights), bpe, call, "cuda")
    want_cut, want_x = got["float32"]
    assert want_cut.shape == (1, 512, 512, 3) and want_cut.norm() > 0
    assert all(torch.isfinite(g).all() for side in got.values() for g in side)
    bf16, fp8 = _against(got["port"][0], want_cut), _against(got["fp8"][0], want_cut)
    whole = {side: _against(got[side][1], want_x) for side in ("port", "fp8")}
    with capsys.disabled():
        print("\nGRAD " + json.dumps({
            "seed": seed, "card": torch.cuda.get_device_name(dev),
            "clip": {"bf16": bf16, "fp8": fp8}, "whole": whole}))
    assert bf16[0] >= COS_MIN and bf16[1] <= REL_MAX, bf16
    assert fp8[0] < COS_MIN or fp8[1] > REL_MAX, fp8
    (cos, rel), (fcos, frel) = whole["port"], whole["fp8"]
    assert cos >= WHOLE_COS_MIN and rel <= WHOLE_REL_MAX, whole
    assert fcos < WHOLE_COS_MIN or frel > WHOLE_REL_MAX, whole
