"""Multi-head self-attention on Hopper: K-attn-f and K-attn-b, their plain
PyTorch versions, the launch plan, and the autograd Function the UNet calls.

Counterpart of ``cgd_tpu/kernels/attention_pallas.py``. Hand-written CUDA
kernels replace its two Pallas kernels: a flash-attention forward that also
writes the per-row log-sum-exp, and a deterministic backward that recomputes
P from it. Every head dim (64: the UNets at 64, 256 and 512px; 128, 192 and
256: the 128px model) runs the Hopper bodies of ``csrc/attn_fwd.cu`` and
``csrc/attn_bwd.cu``: a TMA ring, a producer warpgroup, two consumer
warpgroups on ``wgmma`` with the softmax and the accumulators in registers,
and a two-launch backward. ``attn_plan`` is the launch geometry the wrapper
and the kernels agree on.

- ``attention_fwd_plain`` / ``attention_bwd_plain``: exactly the math of
  ``_fwd_kernel`` / ``_bwd_kernel`` on ``[N, T, d]`` (q and k each scaled by
  d^-1/4, everything in f32, P kept in f32), results in q's dtype;
- ``attention_fwd`` / ``attention_bwd``: the kernels, reading q, k, v in
  place from the UNet's fused ``[B, T, 3C]`` qkv (``[q_heads | k_heads |
  v_heads]``) and writing ``[B, T, C]`` / ``[B, T, 3C]``;
- ``qkv_attention``: the ``torch.autograd.Function`` mirroring
  ``flash_mha``'s ``custom_vjp``.

At f32 operands (the UNet at ``compute_dtype="float32"``) the same entry
points launch K-attn-f f32 and K-attn-b f32 (``csrc/attn_f32.cu``: the TF32
tensor cores through ``mma.sync`` with the 3xTF32 split, a TMA ring fed by a
producer warp, S and P in registers, one block per 64-column share of the
output; the same fused qkv, log-sum-exp and two-launch backward;
``f32_attn_plan`` is their geometry).

Head dims: the kernels are templates at d = 64, 128, 192 and 256
(``HEAD_DIMS``). A head dim between them (the toy models' 16, say) runs on
the next wider template: the wrappers zero-pad each head of q, k, v (and of
the backward's out and cotangent) to that width, tell the kernel the true d
so that the logits keep their 1/sqrt(d) scale, and slice the padded columns
off the results (``fwd_padded`` / ``bwd_padded``; the padded columns of q
and k add nothing to q k^T, and v's give output columns of zeros).

Dispatch: a tensor on the CPU takes the plain versions; a CUDA tensor
launches the kernels or raises (a head dim above 256, a dtype other than
bfloat16 or float32, a failed build). Nothing falls back.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from cgd_tpu_torch.kernels import _build

HEAD_DIMS = (64, 128, 192, 256)  # the kernels' templates

# launches of each kernel since the last reset_launch_counts(), in all and by
# the caller's head dim (a padded one under its own d)
# (a replayed CUDA graph adds what its capture counted: launch_counters)
LAUNCHES = {"attn_fwd": 0, "attn_bwd": 0, "attn_fwd_f32": 0, "attn_bwd_f32": 0}
LAUNCHES_BY_D = {d: dict.fromkeys(LAUNCHES, 0) for d in HEAD_DIMS}

# the kernels' geometry (csrc/attn_common.cuh)
ROWS = 64         # rows of every tile (the wgmma M) and of the TMA box
BOX = 64          # channels of a TMA box, and of the smallest column share
# streamed tiles in each ring (fwd_stages / bwd_stages): the most that fit a
# block in an even count, so that stage s always serves consumer s % 2
FWD_STAGES = {64: 4, 128: 4, 192: 4, 256: 2}
BWD_STAGES = {64: 4, 128: 4, 192: 2, 256: 2}
COLS0 = 128       # consumer 0's columns where the forward and dQ kernels split D
SMEM_MAX = 232448  # shared memory one block may take on the H100
_ALIGN = 1024


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, *LAUNCHES_BY_D.values()):
        for k in counts:
            counts[k] = 0


def _count(name: str, d: int) -> None:
    LAUNCHES[name] += 1
    LAUNCHES_BY_D.setdefault(d, dict.fromkeys(LAUNCHES, 0))[name] += 1


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------

def _probs(q, k, dh=None):
    d = dh or q.shape[-1]
    scale = 1.0 / math.sqrt(math.sqrt(d))
    s = (q.float() * scale) @ (k.float() * scale).transpose(-1, -2)
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    return p / p.sum(-1, keepdim=True), scale * scale


def attention_fwd_plain(q, k, v, dh=None):
    """softmax(q k^T / sqrt(d)) v for q, k, v [N, T, d]; f32 math, q's dtype
    out. ``dh`` replaces d in the scale (the kernels' contract at a padded
    width)."""
    p, _ = _probs(q, k, dh)
    return (p @ v.float()).to(q.dtype)


def attention_bwd_plain(q, k, v, g, dh=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention_fwd_plain for cotangent g, P recomputed."""
    p, s2 = _probs(q, k, dh)
    g = g.float()
    dp = g @ v.float().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (ds @ k.float()) * s2
    dk = (ds.transpose(-1, -2) @ q.float()) * s2
    dv = p.transpose(-1, -2) @ g
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def to_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, H*d] -> [B*H, T, d]."""
    b, t, c = x.shape
    return x.reshape(b, t, num_heads, c // num_heads).transpose(1, 2).reshape(b * num_heads, t, -1)


def split_heads(qkv: torch.Tensor, num_heads: int):
    """[B, T, 3C] -> q, k, v as [B*H, T, d]."""
    return tuple(to_heads(z, num_heads) for z in qkv.chunk(3, dim=-1))


def merge_heads(x: torch.Tensor, batch: int) -> torch.Tensor:
    """[B*H, T, d] -> [B, T, H*d]."""
    n, t, d = x.shape
    return x.reshape(batch, n // batch, t, d).transpose(1, 2).reshape(batch, t, -1)


def kernel_head_dim(d: int) -> int:
    """The template width that runs heads of width d: d itself, or the next
    wider of ``HEAD_DIMS``."""
    for dk in HEAD_DIMS:
        if d <= dk:
            return dk
    raise ValueError(f"attention: head dim {d} has no kernel (at most {HEAD_DIMS[-1]})")


def pad_heads(x: torch.Tensor, groups: int, d: int, dk: int) -> torch.Tensor:
    """[B, T, groups*d] -> [B, T, groups*dk], each group of d channels
    followed by dk - d zeros (contiguous)."""
    b, t, _ = x.shape
    return F.pad(x.reshape(b, t, groups, d), (0, dk - d)).reshape(b, t, groups * dk)


def unpad_heads(x: torch.Tensor, groups: int, d: int, dk: int) -> torch.Tensor:
    """The inverse of ``pad_heads``: the first d channels of each group
    (contiguous: with one group the reshape alone would give a strided view,
    which the kernels refuse)."""
    b, t, _ = x.shape
    return x.reshape(b, t, groups, dk)[..., :d].reshape(b, t, groups * d).contiguous()


def fwd_padded(qkv: torch.Tensor, num_heads: int, d: int, dk: int, kernel):
    """K-attn-f of heads of width d on the template of width dk >= d:
    ``kernel(qkv, num_heads, dk, d) -> (out, lse)`` runs the template at
    width dk with the logits scaled by 1/sqrt(d). Where dk > d, q, k, v go
    in zero-padded per head and out's padded columns (zeros) come off."""
    if dk == d:
        return kernel(qkv, num_heads, d, d)
    out, lse = kernel(pad_heads(qkv, 3 * num_heads, d, dk), num_heads, dk, d)
    return unpad_heads(out, num_heads, d, dk), lse


def bwd_padded(qkv, out, lse, g, num_heads: int, d: int, dk: int, kernel):
    """K-attn-b as ``fwd_padded``: ``kernel(qkv, out, lse, g, num_heads, dk,
    d) -> dqkv`` at width dk; qkv, out and g go in zero-padded per head (so
    rowsum(g * out) is unchanged), dq / dk / dv come back unpadded."""
    if dk == d:
        return kernel(qkv, out, lse, g, num_heads, d, d)
    dqkv = kernel(pad_heads(qkv, 3 * num_heads, d, dk), pad_heads(out, num_heads, d, dk), lse,
                  pad_heads(g, num_heads, d, dk), num_heads, dk, d)
    return unpad_heads(dqkv, 3 * num_heads, d, dk)


# ---------------------------------------------------------------------------
# launch plan
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def attn_plan(batch: int, heads: int, t: int, d: int) -> dict:
    """The launch plan of K-attn-f / K-attn-b for ``[batch, t, 3*heads*d]``
    (the geometry the wrapper and the kernels agree on; the C entry points
    check the tile, stages and split they are given, and a card test holds
    the shared memory to the kernels').

    Every kernel runs one block per (64-row tile, batch*head): the forward
    and the dQ kernel own q rows and stream K/V tiles, the dK/dV kernel owns
    kv rows and streams Q/dO tiles, through a ring of ``stages[kernel]``
    tiles loaded by the TMA in boxes of 64 channels x 64 rows (d / 64 boxes a
    tile). At d = 64 / 128 the two consumer warpgroups split the streamed
    tiles (``split`` = 2; 1 when there is a single tile, so that each gets
    one); at 192 / 256 they split D instead, and ``cols[kernel]`` gives each
    consumer's column ranges of the output, one per pass over the streamed
    tiles (the dK/dV kernel takes 64-column shares in two passes); ``cols``
    is None where the tiles are split. The backward is two launches."""
    if d not in HEAD_DIMS:
        raise ValueError(f"attention: head dim {d} has no kernel (supported: {HEAD_DIMS})")
    tiles = -(-t // ROWS)
    tile = ROWS * d * 2
    fs, bs = FWD_STAGES[d], BWD_STAGES[d]
    smem = {"fwd": tile + fs * 2 * tile + _ALIGN,
            "bwd_dq": 3 * tile + _ALIGN + bs * 2 * tile + _ALIGN,
            "bwd_dkdv": 2 * tile + bs * (2 * tile + _ALIGN) + _ALIGN}
    grid = (tiles, batch * heads)
    cols = None
    if d > 128:
        halves = (((0, COLS0),), ((COLS0, d),))
        passes = tuple(tuple((c, c + BOX) for c in range(BOX * wg, d, 2 * BOX)) for wg in (0, 1))
        cols = {"fwd": halves, "bwd_dq": halves, "bwd_dkdv": passes}
    return dict(body="wgmma", d=d, q_tile=ROWS, kv_tile=ROWS, tiles=tiles,
                stages={"fwd": fs, "bwd_dq": bs, "bwd_dkdv": bs},
                split=2 if tiles >= 2 else 1, cols=cols,
                grid={k: grid for k in smem}, smem=smem, box=(BOX, ROWS, 1), bwd_launches=2)


# the f32 kernels' geometry (csrc/attn_f32.cu)
F32_BODY = "mma.sync-3xtf32"
F32_WARPS = 4                       # consumer warps of a half, 16 of the block's 64 rows each
F32_COLS = 64                       # output columns of one block: the column split
F32_BOX = 32                        # floats of a TMA box row (128 bytes, one swizzle row)
# rows of the streamed tile and stages of the ring, forward and backward
# (both kernels alike), by head dim: the most stages that fit one block, at
# least three
F32_TILE = {"fwd": dict.fromkeys(HEAD_DIMS, 32), "bwd": {64: 32, 128: 32, 192: 16, 256: 16}}
F32_STAGES = {"fwd": dict.fromkeys(HEAD_DIMS, 4), "bwd": {64: 4, 128: 4, 192: 4, 256: 3}}
# every product: (instruction, A operand, B operand); an operand read from
# shared memory is "k-major" (the reduction runs along its rows' channels)
# or "mn-major" (down its rows, the tokens); "registers" is the accumulator
# of the product before. TF32 wgmma would take only k-major shared operands.
_MMA = "mma.sync.m16n8k8.tf32"
F32_PRODUCTS = {
    "fwd": {"S=Q.K^T": (_MMA, "k-major", "k-major"), "O+=P.V": (_MMA, "registers", "mn-major")},
    "bwd_dq": {"S=Q.K^T": (_MMA, "k-major", "k-major"), "dP=dO.V^T": (_MMA, "k-major", "k-major"),
               "dQ+=dS.K": (_MMA, "registers", "mn-major")},
    "bwd_dkdv": {"S^T=K.Q^T": (_MMA, "k-major", "k-major"),
                 "dP^T=V.dO^T": (_MMA, "k-major", "k-major"),
                 "dV+=P^T.dO": (_MMA, "registers", "mn-major"),
                 "dK+=dS^T.Q": (_MMA, "registers", "mn-major")},
}


def f32_attn_plan(batch: int, heads: int, t: int, d: int) -> dict:
    """The launch plan of K-attn-f f32 / K-attn-b f32 for ``[batch, t,
    3*heads*d]`` f32 (the C entry points check the tiles, stages and column
    share; a card test holds the shared memory to the kernels').

    Every kernel runs one block of ``threads[kernel]`` per (64-row tile,
    batch*head, 64-column share of the output): ``grid[kernel]`` = (tiles,
    batch*heads, d / 64), and ``shares`` the column ranges, each owned by one
    block of a row tile. The forward and the dQ kernel own q rows and stream
    K/V tiles, the dK/dV kernel owns kv rows and streams Q/dO tiles (and
    their lse and D), of ``stream[kernel]`` rows through a ring of
    ``stages[kernel]`` stages, by TMA in boxes of ``box[kernel]`` (32
    channels x the streamed rows x 1). A block is a producer and
    ``halves[kernel]`` halves of four consumer warps (16 rows each): with
    two, streamed tile i goes to half i % 2 (an even ring: stage s always
    serves half s % 2), half 1's sums merge into half 0's at the end, and
    the producer is a warpgroup (setmaxnreg moves its registers to the
    consumers); with one, it is a warp.
    Every product is an ``mma.sync`` at TF32 with the 3xTF32 split
    (``products``). Shared memory: the block's own tiles, the ring, the dK/dV
    kernel's lse and D per stage, and 1 KB of alignment slack. The backward
    is two launches."""
    if d not in HEAD_DIMS:
        raise ValueError(f"attention: head dim {d} has no kernel (supported: {HEAD_DIMS})")
    tf, tb = F32_TILE["fwd"][d], F32_TILE["bwd"][d]
    sf, sb = F32_STAGES["fwd"][d], F32_STAGES["bwd"][d]
    stream = {"fwd": tf, "bwd_dq": tb, "bwd_dkdv": tb}
    stages = {"fwd": sf, "bwd_dq": sb, "bwd_dkdv": sb}
    smem = {"fwd": 4 * (ROWS * d + sf * tf * (d + F32_COLS)) + _ALIGN,
            "bwd_dq": 4 * (2 * ROWS * d + sb * 2 * tb * d) + _ALIGN,
            "bwd_dkdv": 4 * (2 * ROWS * d + sb * 2 * tb * d + sb * 2 * tb) + _ALIGN}
    tiles = -(-t // ROWS)
    grid = (tiles, batch * heads, d // F32_COLS)
    halves = {k: 2 if v % 2 == 0 else 1 for k, v in stages.items()}
    producer = {1: 32, 2: 128}  # a warp, or a warpgroup beside two halves
    return dict(body=F32_BODY, d=d, q_tile=ROWS, tiles=tiles, halves=halves,
                threads={k: producer[h] + 32 * F32_WARPS * h for k, h in halves.items()},
                warps=F32_WARPS, stream=stream, stages=stages,
                streamed_tiles={k: -(-t // v) for k, v in stream.items()},
                cols=F32_COLS, shares=tuple((c, c + F32_COLS) for c in range(0, d, F32_COLS)),
                grid={k: grid for k in smem}, smem=smem,
                box={k: (F32_BOX, v, 1) for k, v in stream.items()},
                products=F32_PRODUCTS, mmas_per_product=3, bwd_launches=2)


# ---------------------------------------------------------------------------
# kernel launchers
# ---------------------------------------------------------------------------

_DTYPES = (torch.bfloat16, torch.float32)  # a kernel set for each


def _bad(name: str, dev, arg: str, t: torch.Tensor, want) -> Exception:
    if t.device != dev:
        return ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
    if t.dtype != want:
        return TypeError(f"{name}: {arg} has dtype {t.dtype}; the CUDA kernels take "
                         f"{want} here (qkv, out and g in bfloat16 or float32, lse in float32)")
    return ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned")


def _check(name: str, num_heads: int, qkv: torch.Tensor, *more) -> Tuple[int, int, int, dict]:
    """One pass over the tensors (device, dtype, contiguity, 16-byte
    alignment; ``more`` = (name, tensor, dtype) triples, dtype None for
    qkv's), then qkv's shape. Returns (b, t, c, plan), the plan of qkv's
    dtype at the template width that runs its head dim."""
    dev = qkv.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    dt = qkv.dtype if qkv.dtype in _DTYPES else torch.bfloat16
    for arg, t, want in (("qkv", qkv, dt), *more):
        want = want or dt
        if t.device != dev or t.dtype != want or not t.is_contiguous() or t.data_ptr() % 16:
            raise _bad(name, dev, arg, t, want)
    b, t, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c % num_heads:
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)} does not split into 3 x {num_heads} heads")
    plan = f32_attn_plan if dt == torch.float32 else attn_plan
    return b, t, c, plan(b, num_heads, t, kernel_head_dim(c // num_heads))


def _launch(dev: torch.device, fn, *args) -> int:
    """Call a kernel's C entry point on ``dev``'s current stream (switching
    the current device only where it differs)."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, _build.stream(dev))
    with torch.cuda.device(dev):
        return fn(*args, _build.stream(dev))


def attention_fwd(qkv: torch.Tensor, num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-attn-f. qkv [B, T, 3C] bf16 or f32 on a card -> (out [B, T, C] in
    qkv's dtype, lse [B*H, T] f32, the per-row log-sum-exp of the scaled
    logits). f32 runs K-attn-f f32."""
    b, t, c, plan = _check("attention_fwd", num_heads, qkv)
    return fwd_padded(qkv, num_heads, c // num_heads, plan["d"],
                      functools.partial(_fwd_kernel, plan=plan))


def _fwd_kernel(qkv, num_heads: int, dk: int, dh: int, plan: dict):
    """K-attn-f at template width dk on checked tensors, logits scaled by
    1/sqrt(dh); launches counted under dh."""
    b, t, _ = qkv.shape
    out = torch.empty((b, t, num_heads * dk), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b * num_heads, t), dtype=torch.float32, device=qkv.device)
    lib = _build.library()
    if qkv.dtype == torch.float32:
        status = _launch(qkv.device, lib.cgd_attn_fwd_f32, qkv.data_ptr(), out.data_ptr(),
                         lse.data_ptr(), b, t, num_heads, dk, dh, plan["stream"]["fwd"],
                         plan["stages"]["fwd"], plan["cols"])
        _build.check(status, "attention_fwd (f32)")
        _count("attn_fwd_f32", dh)
        return out, lse
    status = _launch(qkv.device, lib.cgd_attn_fwd, qkv.data_ptr(), out.data_ptr(),
                     lse.data_ptr(), b, t, num_heads, dk, dh, plan["kv_tile"],
                     plan["stages"]["fwd"], plan["split"])
    _build.check(status, "attention_fwd")
    _count("attn_fwd", dh)
    return out, lse


def attention_bwd(qkv, out, lse, g, num_heads: int) -> torch.Tensor:
    """K-attn-b. The forward's qkv, out and lse and the cotangent g [B, T, C]
    -> dqkv [B, T, 3C] in qkv's dtype (deterministic). f32 runs K-attn-b
    f32."""
    b, t, c, plan = _check("attention_bwd", num_heads, qkv, ("out", out, None),
                           ("lse", lse, torch.float32), ("g", g, None))
    if out.shape != (b, t, c) or g.shape != (b, t, c) or lse.shape != (b * num_heads, t):
        raise ValueError("attention_bwd: out / g / lse do not fit qkv")
    return bwd_padded(qkv, out, lse, g, num_heads, c // num_heads, plan["d"],
                      functools.partial(_bwd_kernel, plan=plan))


def _bwd_kernel(qkv, out, lse, g, num_heads: int, dk: int, dh: int, plan: dict):
    """K-attn-b at template width dk on checked tensors (scale 1/sqrt(dh))."""
    if qkv.dtype == torch.float32:
        return _attention_bwd_f32(qkv, out, lse, g, num_heads, dk, dh, plan)
    b, t, c3 = qkv.shape
    bf = torch.bfloat16
    # dqkv and the D scratch (f32 [B*H, T], at byte 2n: 16-byte aligned) in one
    # allocation
    n = b * t * c3
    buf = torch.empty(n + 2 * b * num_heads * t, dtype=bf, device=qkv.device)
    dqkv = buf.as_strided((b, t, c3), (t * c3, c3, 1))
    gbase = buf.data_ptr()
    status = _launch(qkv.device, _build.library().cgd_attn_bwd, qkv.data_ptr(), out.data_ptr(),
                     g.data_ptr(), lse.data_ptr(), gbase + 2 * n, gbase, b, t, num_heads, dk, dh,
                     plan["kv_tile"], plan["stages"]["bwd_dq"], plan["split"])
    _build.check(status, "attention_bwd")
    _count("attn_bwd", dh)
    return dqkv


def _attention_bwd_f32(qkv, out, lse, g, num_heads: int, dk: int, dh: int,
                       plan: dict) -> torch.Tensor:
    """K-attn-b f32 on checked tensors: dqkv [B, T, 3C] f32."""
    b, t, c3 = qkv.shape
    # dqkv and the D scratch (f32 [B*H, T], at element n: 16-byte aligned)
    # in one allocation
    n = b * t * c3
    buf = torch.empty(n + b * num_heads * t, dtype=torch.float32, device=qkv.device)
    dqkv = buf.as_strided((b, t, c3), (t * c3, c3, 1))
    status = _launch(qkv.device, _build.library().cgd_attn_bwd_f32, qkv.data_ptr(),
                     out.data_ptr(), g.data_ptr(), lse.data_ptr(), buf.data_ptr() + 4 * n,
                     buf.data_ptr(), b, t, num_heads, dk, dh, plan["stream"]["bwd_dq"],
                     plan["stages"]["bwd_dq"], plan["cols"])
    _build.check(status, "attention_bwd (f32)")
    _count("attn_bwd_f32", dh)
    return dqkv


# ---------------------------------------------------------------------------
# autograd Function (flash_mha's custom_vjp)
# ---------------------------------------------------------------------------

class _QKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.num_heads = num_heads
        if qkv.device.type == "cpu":
            ctx.save_for_backward(qkv)
            return merge_heads(attention_fwd_plain(*split_heads(qkv, num_heads)), qkv.shape[0])
        out, lse = attention_fwd(qkv, num_heads)
        ctx.save_for_backward(qkv, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        # saved_tensors read once: under a non-reentrant checkpoint
        # (models/unet.py rematerialized) each read unpacks again
        saved = ctx.saved_tensors
        if len(saved) == 1:  # the CPU's plain version
            (qkv,) = saved
            b, h = qkv.shape[0], ctx.num_heads
            grads = attention_bwd_plain(*split_heads(qkv, h), to_heads(g, h))
            return torch.cat([merge_heads(z, b) for z in grads], dim=-1), None
        qkv, out, lse = saved
        return attention_bwd(qkv, out, lse, g.contiguous(), ctx.num_heads), None


def qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention of a fused [B, T, 3C] qkv laid out [q_heads | k_heads |
    v_heads] -> [B, T, C]: K-attn-f forward, K-attn-b backward on a card; the
    plain versions on the CPU."""
    return _QKVAttention.apply(qkv, num_heads)
