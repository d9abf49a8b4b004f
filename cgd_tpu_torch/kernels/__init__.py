"""The port's hand-written CUDA kernels and their plain versions."""


def launch_counters():
    """Every launch counter of the kernels: the dicts of counts that their
    wrappers add 1 to at each launch (each module's ``LAUNCHES`` and the
    attention's ``LAUNCHES_BY_D``). A CUDA graph's replay adds what its
    capture counted (``diffusion.sampler._StepGraph``)."""
    from cgd_tpu_torch.kernels import attention, bn_act, conv3x3, warp

    return [conv3x3.LAUNCHES, warp.LAUNCHES, attention.LAUNCHES, bn_act.LAUNCHES,
            *attention.LAUNCHES_BY_D.values()]
