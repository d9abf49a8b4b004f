"""The timing helpers of cgd_tpu_torch/tools/attn_bench.py that run
without a card: which device readings are held as lost."""

from cgd_tpu_torch.tools.attn_bench import suspect


def test_a_reading_the_profiler_lost_or_did_not_record_is_suspect():
    """A device time far under the same call's queued CUDA-event time, or
    nan (the profiler recorded no kernel: device_ms's "not measured"), is
    suspect; one near the event time is not."""
    assert suspect(0.5, 1.0)
    assert suspect(float("nan"), 1.0)
    assert not suspect(0.8, 1.0)
