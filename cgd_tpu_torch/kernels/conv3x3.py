"""The 3x3 conv family on Hopper: K-fwd and K-dx, their plain PyTorch
versions, and the autograd Functions the UNet calls.

Counterpart of ``cgd_tpu/kernels/conv_pallas.py``. Two hand-written CUDA
kernels (``csrc/conv3x3_fwd.cu``, ``csrc/conv3x3_dx.cu``) replace its two
Pallas kernels on the sampling path:

- ``conv3x3_fwd``: 3x3, stride-1, pad-1 NHWC conv with HWIO weights and a
  fused bias, optionally with the prologue ``act = silu(x*A + B)`` (GroupNorm
  apply + emb scale-shift folded into per-(batch, channel) f32 vectors), a
  residual ``skip`` added in the output write, and a nearest-2x ``up`` between
  the activation and the taps. Given ``etop``/``ebot`` it runs as K-halo, on
  one shard of a height-split image: the neighbour shards' boundary rows
  (already activated) take the place of the zero pad above and below, as in
  the Pallas kernel's ``explicit_halo`` mode (``kernels/conv_spmd.py``
  builds them).
- ``conv3x3_dx``: the one-pass backward of the prologue conv: transpose conv
  of the cotangent, then ``dx = acc*silu'(pre)*A`` and the dA/dB reductions.
  At the 512^2 classes its launches are counted as K-dx-w (see
  ``dx_wtiled``), the class that replaces the Pallas ``_conv3x3_dx_wtiled``.

Both kernels share one Hopper main loop (TMA-staged input patches, wgmma,
a producer warpgroup); ``conv_plan`` is the launch geometry the wrapper and
the kernel agree on.

At f32 operands both wrappers run ``csrc/conv3x3_f32.cu`` (3xTF32 on
``wgmma`` fed by a TMA ring, the weights split once per call into K-major
hi / lo, persistent blocks; ``f32_plan`` is its geometry): ``conv3x3_fwd``
as K-fwd f32 in the plain, prologue, residual and up modes (the LPIPS VGG16's convs, and the UNet at
``compute_dtype="float32"``) and, given ``etop``/``ebot``, as K-halo f32 in
the plain, prologue and residual modes (the height-split UNet at
``compute_dtype="float32"``); ``conv3x3_dx`` as K-dx f32 (one geometry for
both of K-dx's classes, then a fixed-order dA/dB sum). Split K where the
tiles do not fill the card, summed in a fixed order.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor launches
the kernel or raises. Nothing falls back from a failed build or launch.
Each wrapper counts its kernel launches in ``LAUNCHES``.

The four public functions mirror the four ``custom_vjp``s of the JAX package:
``conv3x3``, ``conv3x3_gn_silu``, ``conv3x3_gn_silu_add`` and
``conv3x3_gn_silu_up``. Their input gradients run on the kernels too; the
weight and bias gradients are plain PyTorch, computed only when asked for
(sampling differentiates with respect to the image only).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from cgd_tpu_torch.kernels import _build

# launches of each kernel since the last reset_launch_counts()
# (a replayed CUDA graph adds what its capture counted: launch_counters)
LAUNCHES = {"conv3x3_fwd": 0, "conv3x3_fwd_halo": 0, "conv3x3_dx": 0, "conv3x3_dx_wtiled": 0,
            "conv3x3_fwd_f32": 0, "conv3x3_fwd_halo_f32": 0, "conv3x3_dx_f32": 0}

_K_ALIGN = 64  # kernels need Cin % 64 == 0 (one 128-byte K chunk) ...
_N_ALIGN = 8   # ... and Cout % 8 == 0 (16-byte TMA strides)
_WTILED_MIN_W = 512  # the K-dx-w class from this image width up (the 512^2 classes)

# the launch geometry of csrc/conv3x3_common.cuh (conv_plan mirrors it)
PATCH_H, PATCH_W = 8, 16  # output patch of one block: 128 pixels
BK = 64                   # input channels per K chunk
SMEM_MAX = 232448         # shared memory one block may take on the H100
_SMEM_STATIC, _SMEM_ALIGN = 256, 1024
_MIN_SPLIT_CHUNKS = 2     # K chunks per split, at least


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------

def _conv_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 pad-1 conv of NHWC x with HWIO w, in x's dtype, NHWC out."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1)


def _silu_chain(x, A, B):
    """pre, sigmoid(pre), act for act = silu(x*A + B), all f32."""
    pre = x.float() * A[:, None, None, :] + B[:, None, None, :]
    sig = torch.sigmoid(pre)
    return pre, sig, pre * sig


def _up2(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def conv3x3_fwd_plain(x, w, bias, A=None, B=None, skip=None, up=False):
    """Plain PyTorch version of K-fwd: the activation rounds to x's dtype
    before the conv (as the Pallas kernel does), the epilogue adds bias and
    skip in f32 and rounds once."""
    h = x if A is None else _silu_chain(x, A, B)[2].to(x.dtype)
    if up:
        h = _up2(h)
    out = _conv_nhwc(h, w).float() + bias.float()
    if skip is not None:
        out = out + skip.float()
    return out.to(x.dtype)


def conv3x3_fwd_halo_plain(x, w, bias, A=None, B=None, skip=None, etop=None, ebot=None):
    """Plain PyTorch version of K-halo: ``[etop, act(x), ebot]`` stacked on
    H, conv with H pad 0 and W pad 1 (``conv_spmd._xla_reference`` of the
    JAX package), the epilogue of ``conv3x3_fwd_plain``."""
    h = x if A is None else _silu_chain(x, A, B)[2].to(x.dtype)
    h = torch.cat([etop.to(h.dtype), h, ebot.to(h.dtype)], dim=1)
    out = F.conv2d(h.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=(0, 1))
    out = out.permute(0, 2, 3, 1).float() + bias.float()
    if skip is not None:
        out = out + skip.float()
    return out.to(x.dtype)


def conv3x3_dx_plain(g, wt, x, A, B):
    """Plain PyTorch version of K-dx: (dx, dA, dB)."""
    acc = _conv_nhwc(g, wt).float()
    pre, sig, _ = _silu_chain(x, A, B)
    dpre = acc * (sig * (1.0 + pre * (1.0 - sig)))
    dx = (dpre * A[:, None, None, :]).to(g.dtype)
    return dx, (dpre * x.float()).sum((1, 2)), dpre.sum((1, 2))


# ---------------------------------------------------------------------------
# kernel launchers
# ---------------------------------------------------------------------------

def _check_cuda(name: str, dev: torch.device, dtype=torch.bfloat16, **tensors) -> None:
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        want = torch.float32 if arg in ("A", "B") else dtype
        if t.dtype != want:
            raise TypeError(
                f"{name}: {arg} has dtype {t.dtype}; with {dtype} operands the CUDA "
                f"kernel takes {want} here (the operands share one dtype, bfloat16 "
                "or float32; A and B are float32)"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def _pad_to(t: Optional[torch.Tensor], dim: int, size: int) -> Optional[torch.Tensor]:
    if t is None or t.shape[dim] == size:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, size - t.shape[dim]]
    return F.pad(t, pad).contiguous()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def tile_n(cout: int) -> int:
    """The N tile for ``cout`` (padded) output channels: 16 for the
    eps/sigma output conv, 128 up to 128 channels, else 256."""
    return 16 if cout <= 16 else 128 if cout <= 128 else 256


def smem_bytes(bn: int, up: bool) -> Tuple[int, int]:
    """(dynamic shared memory of one block, B ring stages), as
    ``cgd::Layout``: three A stages of the staged patch (10 rows, 6 with up,
    each row in 1 KB-aligned slots), as many B stages (BK x bn bf16) as fit,
    at most 6, and 1 KB of alignment slack. The prologue activates in place
    and takes no memory of its own."""
    rh, rw = (PATCH_H // 2 + 2, PATCH_W // 2 + 2) if up else (PATCH_H + 2, PATCH_W + 2)
    a = 3 * rh * _round_up(rw * BK * 2, _SMEM_ALIGN)
    b_bytes = BK * bn * 2
    stages = min(6, (SMEM_MAX - _SMEM_STATIC - _SMEM_ALIGN - a) // b_bytes)
    return a + stages * b_bytes + _SMEM_ALIGN, stages


def conv_plan(b: int, h: int, w: int, cin: int, cout: int, up: bool = False,
              halo: bool = False, sms: int = 132, split: bool = True) -> dict:
    """The launch plan of one K-fwd / K-dx call, the geometry the wrapper
    and the kernel must agree on (the C entry point checks what it is given
    and sizes shared memory the same way; a card test holds the two equal).

    ``h``/``w`` are the input image's; ``cin``/``cout`` the unpadded channel
    counts (K-dx: Cg / Cx). The output (2h x 2w with ``up``) is tiled in 8 x 16
    patches, Cout in N tiles of ``bn``, Cin in chunks of BK = 64. Split K
    (chunks over ``ksplit`` blocks) when the tiles alone do not fill the
    ``sms`` SMs, one block each, at least two chunks per split. Per chunk a
    block stages its patch's input window (output rows / cols -1 .. 8 / 16,
    in source coordinates with ``up``) one row per TMA load."""
    cin_p, cout_p = _round_up(cin, _K_ALIGN), _round_up(cout, _N_ALIGN)
    ho, wo = (2 * h, 2 * w) if up else (h, w)
    bn = tile_n(cout_p)
    patches = -(-ho // PATCH_H) * -(-wo // PATCH_W)
    ntiles = -(-cout_p // bn)
    chunks = cin_p // BK
    tiles = patches * ntiles * b
    ksplit = 1
    if split and tiles < sms:
        ksplit = max(1, min(-(-sms // tiles), chunks // _MIN_SPLIT_CHUNKS))
    rh, rw = (PATCH_H // 2 + 2, PATCH_W // 2 + 2) if up else (PATCH_H + 2, PATCH_W + 2)
    smem, b_stages = smem_bytes(bn, up)
    box_n = min(bn, 64)
    return dict(
        cin=cin_p, cout=cout_p, ho=ho, wo=wo, patch=(PATCH_H, PATCH_W), bk=BK, bn=bn,
        chunks=chunks, ksplit=ksplit, grid=(patches, ntiles, b * ksplit),
        # the staged window (rows x cols) and the TMA boxes, innermost first:
        # one row of x (K-halo: of etop / ebot too), BK rows of the weight
        window=(rh, rw), box_x=(BK, rw, 1, 1), box_halo=(BK, rw, 1, 1) if halo else None,
        swizzle_x=128, box_w=(box_n, BK), swizzle_w=128 if box_n == 64 else 32,
        strides_x=(cin_p * 2, w * cin_p * 2, h * w * cin_p * 2), stride_w=cout_p * 2,
        smem_bytes=smem, b_stages=b_stages,
    )


# the launch geometry of csrc/conv3x3_f32.cu (f32_plan mirrors its make_plan)
F32_BM = 128          # output pixels of one block
F32_BK = 32           # input channels per chunk (one 128-byte swizzle row)
F32_ALIGN = 4         # Cin and Cout padded to a multiple of 4 (16-byte TMA strides)
F32_MAX_SPLIT = 16    # K ranges at most
F32_MAX_WS, F32_MAX_SS = 4, 36  # window and weight-slab stages at most
F32_STATIC = 5120     # static shared memory reserved (mbarriers, K-dx's column sums)
F32_SMS = 132         # the H100 SXM's SMs: the default of f32_plan's ``sms``


F32_THREADS = 384  # a block: the producer warp, 3 activation warps, 2 consumer warpgroups


def f32_tile_n(cout: int) -> int:
    """K-fwd f32's N tile (wgmma's N) for ``cout`` (padded) output channels:
    8 for the eps/sigma conv and the 3-channel input gradient, else 64 (a
    128-wide tile's accumulators spill at the 168 registers a thread has)."""
    return 8 if cout <= 8 else 64


def f32_split_ranges(chunks: int, ksplit: int) -> list:
    """The chunk range [k0, k1) of each of the ``ksplit`` K ranges, as the
    kernel cuts them (split * chunks // ksplit)."""
    return [(s * chunks // ksplit, (s + 1) * chunks // ksplit) for s in range(ksplit)]


@functools.lru_cache(maxsize=1024)
def f32_plan(b: int, h: int, w: int, cin: int, cout: int, up: bool = False,
             dx: bool = False, halo: bool = False, sms: int = F32_SMS) -> dict:
    """The launch plan of one K-fwd f32 call (``dx``: K-dx f32, ``cin`` /
    ``cout`` = Cg / Cx; ``halo``: K-halo f32 on an ``h``-row shard), the
    geometry ``csrc/conv3x3_f32.cu`` computes for itself and checks the
    caller's against (a card test holds the two equal).

    A block computes an output patch of 128 pixels (8 x 16; 4 x 32 on
    outputs of 4-7 rows, 2 x 64 below: the short-patch class; two consumer
    warpgroups of 64) by ``bn`` output channels (``f32_tile_n``: 8 is the
    narrow-N class), over Cin in chunks of 32 channels, ``k8_steps`` wgmma
    k8 steps each (1 where Cin <= 8, 2 where Cin <= 16: the narrow-K class). Where the tiles alone do not fill the ``sms`` SMs, the
    chunks are cut into ``ksplit`` ranges over blocks (split K; the ranges'
    raw sums are added in order by a second pass, ``ws_floats`` of
    workspace). A tile is (patch, K range, image, N tile), numbered patch
    first (``tile_grid``); ``blocks`` = min(tiles, sms) persistent blocks each
    take a contiguous run of tiles (block i: tiles i * tiles // blocks up to
    (i + 1) * tiles // blocks), so that one tile's
    epilogue runs under the next one's loads; with one chunk (Cin <= 32,
    ``resident``) a run's nine weight slabs are loaded once per N tile.
    Per chunk the producer stages the patch's pad-1 window
    (``window`` rows x cols of source pixels; with ``up`` the output is 2h x
    2w and the window is at source resolution), one TMA box a row in a
    ``slot``-byte, 1 KB-aligned slot, and one tap at a time the weight slab
    (``bn`` rows x 32 channels, hi and lo) of the weights split once per call
    into ``wsplit`` = [2, 9, cout8, cink] (K-major: ``split_weights_plain``).
    ``win_stages`` windows and
    ``slab_stages`` slabs in flight, within one block's shared memory.
    K-dx f32 writes one dA/dB partial row per patch (``partial_rows``);
    K-halo f32 stages window rows -1 and h from ``etop`` / ``ebot``. Plans
    are cached by their arguments (the wrappers ask for one per launch):
    the dict is shared, read it only."""
    cin_p, cout_p = _round_up(cin, F32_ALIGN), _round_up(cout, F32_ALIGN)
    cout8 = _round_up(cout_p, 8)
    ho, wo = (2 * h, 2 * w) if up else (h, w)
    ks = f32_k8_steps(cin_p)
    chunks = -(-cin_p // F32_BK)
    bn = f32_tile_n(cout_p)
    ph = 8 if (up or ho >= 8) else 4 if ho >= 4 else 2
    pw = F32_BM // ph
    tiles_x = -(-wo // pw)
    patches = -(-ho // ph) * tiles_x
    ntiles = -(-cout_p // bn)
    tiles = patches * ntiles * b
    ksplit = 1
    if tiles < sms:
        ksplit = max(1, min(sms // tiles, chunks, F32_MAX_SPLIT))
    window = (ph // 2 + 2, pw // 2 + 2) if up else (ph + 2, pw + 2)
    slot = _round_up(window[1] * 128, _SMEM_ALIGN)
    win_bytes, slab_bytes = window[0] * slot, 2 * bn * 128
    win_stages = 4 if bn == 8 else 2
    slab_stages = min(F32_MAX_SS,
                      (SMEM_MAX - F32_STATIC - _SMEM_ALIGN - win_stages * win_bytes) // slab_bytes)
    classes = {name for name, on in (
        ("narrow_k", ks < 4), ("narrow_n", bn == 8), ("split_k", ksplit > 1),
        ("short_patch", ph < 8), ("up", up), ("halo", halo)) if on}
    tiles = patches * ntiles * b * ksplit
    blocks = min(tiles, sms)
    return dict(cin=cin_p, cout=cout_p, cout8=cout8, ho=ho, wo=wo, patch=(ph, pw), bk=F32_BK,
                bn=bn, k8_steps=ks, chunks=chunks, ksplit=ksplit,
                split_ranges=f32_split_ranges(chunks, ksplit),
                tile_grid=(patches, ntiles, b * ksplit), tiles=tiles, blocks=blocks,
                resident=chunks == 1, grid=(blocks,), threads=F32_THREADS,
                window=window, slot=slot, win_stages=win_stages, slab_stages=slab_stages,
                smem_bytes=win_stages * win_bytes + slab_stages * slab_bytes + _SMEM_ALIGN,
                wsplit=(2, 9, cout8, _cin_k(cin_p)),
                ws_floats=ksplit * b * ho * wo * cout_p if ksplit > 1 else 0,
                partial_rows=patches if dx else None,
                halo_rows={-1: "etop", h: "ebot"} if halo else None, classes=classes)


_TF32_ROUND, _TF32_MASK = 0x1000, -0x2000  # round half away from zero at bit 13; low 13 bits off


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """The TF32 rounding of f32 ``v`` (round to nearest, ties away from zero:
    cvt.rna.tf32.f32), as an f32 tensor with the 13 low mantissa bits 0."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + _TF32_ROUND) & _TF32_MASK).view(torch.float32)


def f32_k8_steps(cin: int) -> int:
    """wgmma k8 steps of one 32-channel chunk for ``cin`` (padded) input
    channels: 1 up to 8, 2 up to 16, else 4."""
    return 1 if cin <= 8 else 2 if cin <= 16 else 4


def _cin_k(cin: int) -> int:
    """Length of a split weight row: 8 with one k8 step, else cin rounded
    up to 16."""
    return 8 if f32_k8_steps(cin) == 1 else _round_up(cin, 16)


def _channel_at(pos: int, cin: int) -> int:
    """The input channel the split weights keep at K position ``pos`` of an
    output channel's row (csrc/conv3x3_f32.cu channel_at): with one k8 step
    the natural order; else, within each group of 16, position 8s + t + 4h
    holds channel 4t + 2s + h, the order in which the kernel's 16-byte A
    fragment loads meet wgmma's k8 steps."""
    if f32_k8_steps(cin) == 1:
        return pos
    return (pos & ~15) + 4 * (pos & 3) + 2 * ((pos >> 3) & 1) + ((pos >> 2) & 1)


def split_weights_plain(w: torch.Tensor) -> torch.Tensor:
    """Plain version of the weight split of K-fwd f32 / K-dx f32: w [3, 3,
    cin, cout] f32 (cin, cout multiples of 4) -> [2, 9, cout8, cink] (cout
    rounded up to 8, ``_cin_k``): K-major, a row per output channel, its
    channels placed by ``_channel_at``; [0] the TF32 rounding hi of w, [1]
    the TF32 rounding of w - hi; rows past cout and channels past cin 0."""
    _, _, cin, cout = w.shape
    cout8, cink = _round_up(cout, 8), _cin_k(cin)
    wk = F.pad(w.reshape(9, cin, cout).transpose(1, 2), (0, cink - cin, 0, cout8 - cout))
    wk = wk[:, :, torch.tensor([_channel_at(p, cin) for p in range(cink)])].contiguous().float()
    hi = _tf32_rna(wk)
    return torch.stack([hi, _tf32_rna(wk - hi)])


def _f32_scratch(plan: dict, dev: torch.device):
    wsplit = torch.empty(plan["wsplit"], dtype=torch.float32, device=dev)
    ws = (torch.empty(plan["ws_floats"], dtype=torch.float32, device=dev)
          if plan["ksplit"] > 1 else None)
    return wsplit, ws


def _conv3x3_fwd_f32(x, w, bias, A, B, skip, up, etop=None, ebot=None) -> torch.Tensor:
    """K-fwd f32 on CUDA tensors; K-halo f32 with ``etop``/``ebot``."""
    _check_cuda("conv3x3_fwd", x.device, torch.float32, x=x, w=w, bias=bias, A=A, B=B,
                skip=skip, etop=etop, ebot=ebot)
    b, h, wd, cin = x.shape
    halo = etop is not None
    if halo and (etop.shape != (b, 1, wd, cin) or ebot.shape != (b, 1, wd, cin)):
        raise ValueError(f"conv3x3_fwd: etop {tuple(etop.shape)} / ebot {tuple(ebot.shape)} "
                         f"!= {(b, 1, wd, cin)}")
    cout = w.shape[-1]
    if w.shape != (3, 3, cin, cout) or bias.shape != (cout,):
        raise ValueError(f"conv3x3_fwd: w {tuple(w.shape)} / bias {tuple(bias.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    plan = f32_plan(b, h, wd, cin, cout, up, halo=halo, sms=_sms(x.device))
    ho, wo = plan["ho"], plan["wo"]
    if A is not None and (A.shape != (b, cin) or B.shape != (b, cin)):
        raise ValueError(f"conv3x3_fwd: A {tuple(A.shape)} / B {tuple(B.shape)} != {(b, cin)}")
    if skip is not None and skip.shape != (b, ho, wo, cout):
        raise ValueError(f"conv3x3_fwd: skip {tuple(skip.shape)} != {(b, ho, wo, cout)}")
    cin_p, cout_p = plan["cin"], plan["cout"]
    x, w, A, B = _pad_to(x, 3, cin_p), _pad_to(_pad_to(w, 2, cin_p), 3, cout_p), \
        _pad_to(A, 1, cin_p), _pad_to(B, 1, cin_p)
    etop, ebot = _pad_to(etop, 3, cin_p), _pad_to(ebot, 3, cin_p)
    bias, skip = _pad_to(bias, 0, cout_p), _pad_to(skip, 3, cout_p)
    out = torch.empty((b, ho, wo, cout_p), dtype=torch.float32, device=x.device)
    wsplit, ws = _f32_scratch(plan, x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        status = lib.cgd_conv3x3_f32(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(),
            None if A is None else A.data_ptr(), None if B is None else B.data_ptr(),
            None if skip is None else skip.data_ptr(),
            None if etop is None else etop.data_ptr(), None if ebot is None else ebot.data_ptr(),
            out.data_ptr(), wsplit.data_ptr(), None if ws is None else ws.data_ptr(),
            b, h, wd, cin_p, cout_p, int(up), plan["bn"], plan["patch"][0], plan["ksplit"],
            _build.stream(x.device))
    _build.check(status, "conv3x3_fwd (f32)")
    LAUNCHES["conv3x3_fwd_halo_f32" if halo else "conv3x3_fwd_f32"] += 1
    return out[..., :cout].contiguous() if cout_p != cout else out


def _conv3x3_dx_f32(g, wt, x, A, B):
    """K-dx f32 on CUDA tensors: (dx, dA, dB)."""
    _check_cuda("conv3x3_dx", g.device, torch.float32, g=g, wt=wt, x=x, A=A, B=B)
    b, h, w_, cg = g.shape
    cx = wt.shape[-1]
    if wt.shape != (3, 3, cg, cx) or x.shape != (b, h, w_, cx) or A.shape != (b, cx) \
            or B.shape != (b, cx):
        raise ValueError("conv3x3_dx: shapes do not fit "
                         f"g {tuple(g.shape)}, wt {tuple(wt.shape)}, x {tuple(x.shape)}")
    dev = g.device
    plan = f32_plan(b, h, w_, cg, cx, dx=True, sms=_sms(dev))
    cg_p, cx_p = plan["cin"], plan["cout"]
    g, wt = _pad_to(g, 3, cg_p), _pad_to(_pad_to(wt, 2, cg_p), 3, cx_p)
    x, A, B = _pad_to(x, 3, cx_p), _pad_to(A, 1, cx_p), _pad_to(B, 1, cx_p)
    dx = torch.empty((b, h, w_, cx_p), dtype=torch.float32, device=dev)
    partial = torch.empty((b, plan["partial_rows"], 2, cx_p), dtype=torch.float32, device=dev)
    dA = torch.empty((b, cx_p), dtype=torch.float32, device=dev)
    dB = torch.empty((b, cx_p), dtype=torch.float32, device=dev)
    wsplit, ws = _f32_scratch(plan, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.cgd_conv3x3_dx_f32(
            g.data_ptr(), wt.data_ptr(), x.data_ptr(), A.data_ptr(), B.data_ptr(),
            dx.data_ptr(), wsplit.data_ptr(), None if ws is None else ws.data_ptr(),
            partial.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            b, h, w_, cg_p, cx_p, plan["bn"], plan["patch"][0], plan["ksplit"],
            _build.stream(dev))
    _build.check(status, "conv3x3_dx (f32)")
    LAUNCHES["conv3x3_dx_f32"] += 1
    if cx_p != cx:
        return dx[..., :cx].contiguous(), dA[:, :cx].contiguous(), dB[:, :cx].contiguous()
    return dx, dA, dB


def _sms(dev: torch.device) -> int:
    return _sm_count(torch.device(dev).index or 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _workspace(ksplit: int, n: int, dev: torch.device) -> Optional[torch.Tensor]:
    if ksplit == 1:
        return None
    return torch.empty(ksplit * n, dtype=torch.float32, device=dev)


def conv3x3_fwd(x, w, bias, A=None, B=None, skip=None, up=False, etop=None, ebot=None
                ) -> torch.Tensor:
    """K-fwd. x [b,hs,ws,cin]; w [3,3,cin,cout]; bias [cout]; A/B [b,cin]
    f32 or None; skip [b,ho,wo,cout] or None -> [b,ho,wo,cout] in x's dtype,
    (ho, wo) = (2hs, 2ws) with ``up``. ``etop``/``ebot`` [b,1,ws,cin] (both or
    neither, no ``up``): K-halo, the rows above and below x, post-activation.
    bf16 operands on CUDA run K-fwd (K-halo with etop/ebot); f32 operands
    run K-fwd f32 (K-halo f32 with etop/ebot). No autograd."""
    halo = etop is not None
    if halo != (ebot is not None) or (halo and up):
        raise ValueError("conv3x3_fwd: etop and ebot go together and take no up")
    if x.device.type == "cpu":
        if halo:
            return conv3x3_fwd_halo_plain(x, w, bias, A, B, skip, etop, ebot)
        return conv3x3_fwd_plain(x, w, bias, A, B, skip, up)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_fwd: no kernel for device {x.device}")
    if (A is None) != (B is None) or (up and (A is None or skip is not None)):
        raise ValueError("conv3x3_fwd: unsupported fusion (A and B go together; "
                         "up needs the prologue and takes no skip)")
    if x.dtype == torch.float32:
        return _conv3x3_fwd_f32(x, w, bias, A, B, skip, up, etop, ebot)
    _check_cuda("conv3x3_fwd", x.device, x=x, w=w, bias=bias, A=A, B=B, skip=skip,
                etop=etop, ebot=ebot)
    b, hs, ws, cin = x.shape
    if halo and (etop.shape != (b, 1, ws, cin) or ebot.shape != (b, 1, ws, cin)):
        raise ValueError(f"conv3x3_fwd: etop {tuple(etop.shape)} / ebot {tuple(ebot.shape)} "
                         f"!= {(b, 1, ws, cin)}")
    cout = w.shape[-1]
    if w.shape != (3, 3, cin, cout) or bias.shape != (cout,):
        raise ValueError(f"conv3x3_fwd: w {tuple(w.shape)} / bias {tuple(bias.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    ho, wo = (2 * hs, 2 * ws) if up else (hs, ws)
    if skip is not None and skip.shape != (b, ho, wo, cout):
        raise ValueError(f"conv3x3_fwd: skip {tuple(skip.shape)} != {(b, ho, wo, cout)}")
    plan = conv_plan(b, hs, ws, cin, cout, up, halo, _sms(x.device))
    # skinny channel counts (RGB in, eps+sigma out) are zero-padded
    cin_p, cout_p = plan["cin"], plan["cout"]
    x, w, A, B = _pad_to(x, 3, cin_p), _pad_to(w, 2, cin_p), _pad_to(A, 1, cin_p), _pad_to(B, 1, cin_p)
    etop, ebot = _pad_to(etop, 3, cin_p), _pad_to(ebot, 3, cin_p)
    w, bias, skip = _pad_to(w, 3, cout_p), _pad_to(bias, 0, cout_p), _pad_to(skip, 3, cout_p)
    out = torch.empty((b, ho, wo, cout_p), dtype=x.dtype, device=x.device)
    lib = _build.library()
    ksplit = plan["ksplit"]
    ws_buf = _workspace(ksplit, out.numel(), x.device)
    with torch.cuda.device(x.device):
        status = lib.cgd_conv3x3_fwd(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(),
            None if A is None else A.data_ptr(), None if B is None else B.data_ptr(),
            None if skip is None else skip.data_ptr(),
            None if etop is None else etop.data_ptr(), None if ebot is None else ebot.data_ptr(),
            out.data_ptr(), None if ws_buf is None else ws_buf.data_ptr(),
            b, hs, ws, cin_p, cout_p, int(up), plan["bn"], ksplit, _build.stream(x.device),
        )
    _build.check(status, "conv3x3_fwd")
    LAUNCHES["conv3x3_fwd_halo" if halo else "conv3x3_fwd"] += 1
    return out[..., :cout].contiguous() if cout_p != cout else out


def dx_wtiled(w: int, ksplit: int) -> bool:
    """K-dx's launch classes: K-dx-w (``LAUNCHES["conv3x3_dx_wtiled"]``)
    where W >= 512 (the 512^2 classes, where the JAX package's
    _pick_dx_tiles admits its W-tiled kernel) and the output tiles fill the
    card without split K; K-dx otherwise. Both run the same kernel over
    8 x 16 output patches."""
    return w >= _WTILED_MIN_W and ksplit == 1


def conv3x3_dx(g, wt, x, A, B, wtiled: Optional[bool] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K-dx. g [b,h,w,cg] cotangent; wt [3,3,cg,cx] flipped/transposed
    weights; x [b,h,w,cx] pre-activation input; A/B [b,cx] f32
    -> dx [b,h,w,cx] in g's dtype, dA/dB [b,cx] f32. No autograd.
    ``wtiled`` forces the launch class (None: ``dx_wtiled``'s rule; True
    also forbids split K); K-dx-w launches count under
    ``LAUNCHES["conv3x3_dx_wtiled"]``. f32 operands run K-dx f32, which has
    one geometry for both classes (``f32_plan``), counted under
    ``LAUNCHES["conv3x3_dx_f32"]``; ``wtiled`` changes nothing there."""
    if g.device.type == "cpu":
        return conv3x3_dx_plain(g, wt, x, A, B)
    if g.device.type != "cuda":
        raise ValueError(f"conv3x3_dx: no kernel for device {g.device}")
    if g.dtype == torch.float32:
        return _conv3x3_dx_f32(g, wt, x, A, B)
    _check_cuda("conv3x3_dx", g.device, g=g, wt=wt, x=x, A=A, B=B)
    b, h, w_, cg = g.shape
    cx = wt.shape[-1]
    if wt.shape != (3, 3, cg, cx) or x.shape != (b, h, w_, cx) or A.shape != (b, cx) \
            or B.shape != (b, cx):
        raise ValueError("conv3x3_dx: shapes do not fit "
                         f"g {tuple(g.shape)}, wt {tuple(wt.shape)}, x {tuple(x.shape)}")
    plan = conv_plan(b, h, w_, cg, cx, sms=_sms(g.device))
    if wtiled is None:
        wtiled = dx_wtiled(w_, plan["ksplit"])
    if wtiled:
        plan = conv_plan(b, h, w_, cg, cx, sms=_sms(g.device), split=False)
    cg_p, cx_p, ksplit = plan["cin"], plan["cout"], plan["ksplit"]
    g, wt = _pad_to(g, 3, cg_p), _pad_to(wt, 2, cg_p)
    wt, x, A, B = _pad_to(wt, 3, cx_p), _pad_to(x, 3, cx_p), _pad_to(A, 1, cx_p), _pad_to(B, 1, cx_p)
    lib = _build.library()
    dx = torch.empty((b, h, w_, cx_p), dtype=g.dtype, device=g.device)
    chunks = lib.cgd_conv3x3_dx_chunks(h, w_, ksplit, int(wtiled))
    partial = torch.empty((b, chunks, 2, cx_p), dtype=torch.float32, device=g.device)
    dA = torch.empty((b, cx_p), dtype=torch.float32, device=g.device)
    dB = torch.empty((b, cx_p), dtype=torch.float32, device=g.device)
    ws_buf = _workspace(ksplit, dx.numel(), g.device)
    with torch.cuda.device(g.device):
        status = lib.cgd_conv3x3_dx(
            g.data_ptr(), wt.data_ptr(), x.data_ptr(), A.data_ptr(), B.data_ptr(),
            dx.data_ptr(), partial.data_ptr(), None if ws_buf is None else ws_buf.data_ptr(),
            dA.data_ptr(), dB.data_ptr(), b, h, w_, cg_p, cx_p, plan["bn"], ksplit, int(wtiled),
            _build.stream(g.device),
        )
    _build.check(status, "conv3x3_dx")
    LAUNCHES["conv3x3_dx_wtiled" if wtiled else "conv3x3_dx"] += 1
    if cx_p != cx:
        return dx[..., :cx].contiguous(), dA[:, :cx].contiguous(), dB[:, :cx].contiguous()
    return dx, dA, dB


# ---------------------------------------------------------------------------
# autograd Functions (the custom_vjps of conv_pallas.py)
# ---------------------------------------------------------------------------

def _flip_t(w: torch.Tensor) -> torch.Tensor:
    """dx of a stride-1 pad-1 3x3 conv is the same conv with taps flipped
    and in/out channels swapped."""
    return w.detach().flip(0, 1).transpose(2, 3).contiguous()


def _dw(act: torch.Tensor, w: torch.Tensor, g: torch.Tensor, padding=1) -> torch.Tensor:
    """Plain weight gradient (HWIO) of conv3x3(act, w) for cotangent g."""
    dw = torch.nn.grad.conv2d_weight(
        act.permute(0, 3, 1, 2), tuple(w.permute(3, 2, 0, 1).shape),
        g.to(act.dtype).permute(0, 3, 1, 2), padding=padding,
    )
    return dw.permute(2, 3, 1, 0).to(w.dtype)


def _db(g: torch.Tensor) -> torch.Tensor:
    return g.float().sum((0, 1, 2)).to(g.dtype)


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        return conv3x3_fwd(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_fwd(g, _flip_t(w), torch.zeros(w.shape[2], dtype=w.dtype, device=w.device))
        if ctx.needs_input_grad[1]:
            dw = _dw(x, w, g)
        if ctx.needs_input_grad[2]:
            db = _db(g)
        return dx, dw, db


class _Conv3x3GnSilu(torch.autograd.Function):
    """conv3x3(silu(x*A + B)) + bias [+ skip]; backward on K-dx."""

    @staticmethod
    def forward(ctx, x, A, B, w, bias, skip):
        ctx.save_for_backward(x, A, B, w)
        ctx.has_skip = skip is not None
        return conv3x3_fwd(x, w, bias, A, B, skip)

    @staticmethod
    def backward(ctx, g):
        x, A, B, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dA = dB = dw = db = None
        if any(ctx.needs_input_grad[:3]):
            dx, dA, dB = conv3x3_dx(g, _flip_t(w), x, A, B)
        if ctx.needs_input_grad[3]:
            dw = _dw(_silu_chain(x, A, B)[2].to(x.dtype), w, g)
        if ctx.needs_input_grad[4]:
            db = _db(g)
        dskip = g if ctx.has_skip and ctx.needs_input_grad[5] else None
        return dx, dA, dB, dw, db, dskip


class _Conv3x3GnSiluUp(torch.autograd.Function):
    """conv3x3(nearest_2x(silu(x*A + B))) + bias. Backward: K-fwd as the
    transpose conv in output space, then the exact nearest-2x adjoint (sum of
    the four duplicated cells) and the silu'/affine chain in plain PyTorch."""

    @staticmethod
    def forward(ctx, x, A, B, w, bias):
        ctx.save_for_backward(x, A, B, w)
        return conv3x3_fwd(x, w, bias, A, B, up=True)

    @staticmethod
    def backward(ctx, g):
        x, A, B, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dA = dB = dw = db = None
        if any(ctx.needs_input_grad[:3]):
            da = conv3x3_fwd(g, _flip_t(w), torch.zeros(w.shape[2], dtype=w.dtype, device=w.device))
            b, ho, wo, c = da.shape
            da_act = da.float().reshape(b, ho // 2, 2, wo // 2, 2, c).sum((2, 4))
            pre, sig, _ = _silu_chain(x, A, B)
            dpre = da_act * (sig * (1.0 + pre * (1.0 - sig)))
            dx = (dpre * A[:, None, None, :]).to(x.dtype)
            dA = (dpre * x.float()).sum((1, 2))
            dB = dpre.sum((1, 2))
        if ctx.needs_input_grad[3]:
            dw = _dw(_up2(_silu_chain(x, A, B)[2].to(x.dtype)), w, g)
        if ctx.needs_input_grad[4]:
            db = _db(g)
        return dx, dA, dB, dw, db


def conv3x3(x, w, bias):
    """3x3 stride-1 pad-1 NHWC conv, bias fused (K-fwd; dx on K-fwd)."""
    return _Conv3x3.apply(x, w, bias)


def conv3x3_gn_silu(x, A, B, w, bias):
    """conv3x3(silu(x*A + B)) + bias (K-fwd prologue; backward on K-dx)."""
    return _Conv3x3GnSilu.apply(x, A, B, w, bias, None)


def conv3x3_gn_silu_add(x, A, B, w, bias, skip):
    """conv3x3(silu(x*A + B)) + bias + skip (residual fused in the epilogue)."""
    return _Conv3x3GnSilu.apply(x, A, B, w, bias, skip)


def conv3x3_gn_silu_up(x, A, B, w, bias):
    """conv3x3(nearest_2x(silu(x*A + B))) + bias: the up-ResBlock in_conv."""
    return _Conv3x3GnSiluUp.apply(x, A, B, w, bias)
