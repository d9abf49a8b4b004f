"""setup_s: seconds from the process's start to the window's first frame
(imports, the card's context, the kernel library, the seeded weights and
their caches, the first request up to its first saved frame). Host clock."""


def read(ctx):
    return ctx.setup_s
