"""The least time the card could take for the UNet's 3x3 convolutions of
one guided step: each conv's forward and its input gradient, each bound by
the larger of its FLOPs over the bf16 dense peak and its bytes over the
HBM bandwidth. Bytes count each input and output of the function once, at
2 bytes (bf16): forward x, the weights, the output and, where the residual
is added in the conv (a ResBlock's second conv), the skip; input gradient
dy, the weights, dx and, where the GroupNorm-SiLU is fused into the conv's
load (every conv but the first and the one after a down-sampling pool),
x, which that prologue's backward reads. ``convs`` lists the convolutions
with their shapes (the tests hold it to the shapes walked on the meta
device).
"""

from __future__ import annotations

from typing import List

from bench_h100.counts.adm_plan import layers

BYTES = 2


def convs(flags: dict, b: int) -> List[dict]:
    """[{cin, cout, res_in, res_out, residual, prologue}] of the UNet's 3x3
    convs."""
    out = []
    for layer in layers(flags):
        if layer[0] in ("conv_in", "out"):
            _, cin, cout, res = layer
            out.append(dict(cin=cin, cout=cout, res_in=res, res_out=res, residual=False,
                            prologue=layer[0] == "out"))
        elif layer[0] == "res":
            _, cin, cout, mode, res_in, res = layer
            # "down": the pooled input feeds the conv; "up": the conv reads the
            # low-resolution input and writes the upsampled output
            first_in = res if mode == "down" else res_in
            out.append(dict(cin=cin, cout=cout, res_in=first_in, res_out=res, residual=False,
                            prologue=mode != "down"))
            out.append(dict(cin=cout, cout=cout, res_in=res, res_out=res, residual=True,
                            prologue=True))
    for c in out:
        c["batch"] = b
    return out


def seconds(config: dict, call: dict, flops_peak: float, bytes_peak: float) -> float:
    total = 0.0
    for c in convs(config["unet"], call["batch_size"]):
        b, hw_in, hw_out = c["batch"], c["res_in"] ** 2, c["res_out"] ** 2
        f = 2 * b * hw_out * 9 * c["cin"] * c["cout"]
        w = 9 * c["cin"] * c["cout"]
        x, y = b * hw_in * c["cin"], b * hw_out * c["cout"]
        fwd = (x + w + y + (y if c["residual"] else 0)) * BYTES
        dx = (y + w + x + (x if c["prologue"] else 0)) * BYTES
        total += max(f / flops_peak, fwd / bytes_peak) + max(f / flops_peak, dx / bytes_peak)
    return total
