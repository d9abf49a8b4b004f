"""The timing tools' parts that run without a card: which device readings
cgd_tpu_torch/tools/attn_bench.py holds as lost, and the calls
cgd_tpu_torch/tools/warp_bench.py times, on CPU tensors."""

from cgd_tpu_torch.tools.attn_bench import suspect


def test_a_reading_the_profiler_lost_or_did_not_record_is_suspect():
    """A device time far under the same call's queued CUDA-event time, or
    nan (the profiler recorded no kernel: device_ms's "not measured"), is
    suspect; one near the event time is not."""
    assert suspect(0.5, 1.0)
    assert suspect(float("nan"), 1.0)
    assert not suspect(0.8, 1.0)


def test_warp_bench_calls_run_on_the_cpu_and_the_route_is_the_plain_backward():
    """tools/warp_bench.py's calls at its long draw (clamped corners of
    hundreds of pairs a tap) run on CPU tensors too: the route's gradient
    is the plain backward's on the index it builds, bit for bit, and the
    gather's autograd gradient equals it there (the CPU's order); the
    library's scatter sums the same products."""
    import torch

    from cgd_tpu_torch.kernels import warp
    from cgd_tpu_torch.tools import warp_bench

    fns = warp_bench.calls("long", torch.device("cpu"))
    w = fns["inputs"]
    index, g = w["index"], w["g"]
    assert int(index.n_long) > 100 and int(index.offsets.diff().max()) > 128
    (route,), (gather,) = fns["route"](), fns["gather"]()
    plain = warp.warp_bwd_plain(g, index).reshape(route.shape)
    assert torch.equal(route, plain) and torch.equal(gather, plain)
    torch.testing.assert_close(fns["index_put"]().reshape(route.shape), plain)
    assert torch.equal(fns["kernel"](), warp.warp_bwd_plain(g, index))
    assert all(torch.equal(a, b) for a, b in zip(fns["index_plain"](), index))
    assert torch.equal(fns["sort"]()[0].diff().clamp(max=0), torch.zeros(g.shape[0] * 4 - 1,
                                                                         dtype=torch.int32))


def test_the_backward_bound_counts_the_function_bytes_not_the_index_layout():
    """K-warp-b's bound counts g and the gradient, each pair's weight and
    output pixel, and one segment start per source pixel: 48.2 MB at 16
    cutouts of 224^2 x 3, whatever the index holds besides (its per-bin
    starts, the long list)."""
    from cgd_tpu_torch.tools.warp_bench import function_bytes

    nsrc = 16 * 224 * 224
    assert function_bytes(4 * nsrc, nsrc, 3) == 4 * (6 * nsrc + 8 * nsrc + nsrc + 1)
    assert round(function_bytes(4 * nsrc, nsrc, 3) / 1e6, 1) == 48.2


def test_warp_bench_needs_a_card():
    import pytest
    import torch

    from cgd_tpu_torch.tools import warp_bench

    if torch.cuda.is_available():
        pytest.skip("a card is here: the tool would run")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        warp_bench.main([])
