"""The layers of the ADM UNet of a configuration, in forward order, with
the resolution each runs at: what the FLOP count and the conv bound walk.
Entries: ("conv_in", cin, cout, res), ("res", cin, cout, mode, res_in,
res_out) with mode "", "down" or "up", ("attn", ch, res), ("out", cin,
cout, res)."""

from __future__ import annotations

from typing import List

CHANNEL_MULT = {512: (0.5, 1, 1, 2, 2, 4, 4), 256: (1, 1, 2, 2, 4, 4), 128: (1, 1, 2, 3, 4),
                64: (1, 2, 3, 4)}


def layers(flags: dict) -> List[tuple]:
    size, mc = flags["image_size"], flags["num_channels"]
    mult = tuple(flags.get("channel_mult") or CHANNEL_MULT[size])
    attn_ds = {size // int(r) for r in str(flags["attention_resolutions"]).split(",")}
    nrb = flags["num_res_blocks"]
    ch = int(mult[0] * mc)
    out = [("conv_in", 3, ch, size)]
    chans, ds = [ch], 1
    for level, m in enumerate(mult):
        for _ in range(nrb):
            out.append(("res", ch, int(m * mc), "", size // ds, size // ds))
            ch = int(m * mc)
            if ds in attn_ds:
                out.append(("attn", ch, size // ds))
            chans.append(ch)
        if level != len(mult) - 1:
            out.append(("res", ch, ch, "down", size // ds, size // ds // 2))
            chans.append(ch)
            ds *= 2
    out += [("res", ch, ch, "", size // ds, size // ds), ("attn", ch, size // ds),
            ("res", ch, ch, "", size // ds, size // ds)]
    for level, m in list(enumerate(mult))[::-1]:
        for i in range(nrb + 1):
            out.append(("res", ch + chans.pop(), int(m * mc), "", size // ds, size // ds))
            ch = int(m * mc)
            if ds in attn_ds:
                out.append(("attn", ch, size // ds))
            if level and i == nrb:
                out.append(("res", ch, ch, "up", size // ds, size // ds * 2))
                ds //= 2
    out.append(("out", ch, 6 if flags.get("learn_sigma", True) else 3, size))
    return out


def heads(flags: dict, ch: int) -> int:
    head_ch = flags.get("num_head_channels", -1)
    return ch // head_ch if head_ch != -1 else flags.get("num_heads", 1)
