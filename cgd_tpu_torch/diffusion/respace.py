"""Timestep respacing — a copy of ``cgd_tpu/diffusion/respace.py`` (pure
Python), pinned to the original by tests/test_torch_port_step.py.

Reimplements the selection contract of guided_diffusion's
``space_timesteps`` (external dep; contract per SURVEY.md §2b respace row,
exercised by the reference via the ``timestep_respacing`` flag,
cgd/script_util.py:309-315).

Given an original T-step process and a respacing spec, returns the ordered
subset of original timesteps to keep. The respaced process's betas are then
recomputed as beta~_i = 1 - abar_i / abar_{i-1} over the kept subset
(done in :mod:`cgd_tpu_torch.diffusion.gaussian`).
"""

from __future__ import annotations

from typing import List, Sequence, Union


def space_timesteps(num_timesteps: int, section_counts: Union[str, Sequence[int]]) -> List[int]:
    """Pick which original timesteps to retain.

    - ``"ddimN"``: exact-stride selection — requires an integer stride s with
      exactly N steps when stepping 0, s, 2s, ...; raises otherwise.
    - ``"N"`` or ``"a,b,c"``: split the T steps into len(sections) equal
      ranges and spread each section's count evenly within its range.

    Returns a sorted list (ascending original-timestep order) so callers can
    use it directly as a gather index array.
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return list(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired_count} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    section_counts = list(section_counts)

    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: List[int] = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        if section_count <= 1:
            frac_stride = 1.0
        else:
            frac_stride = (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken_steps: List[int] = []
        for _ in range(section_count):
            taken_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken_steps
        start_idx += size
    return sorted(all_steps)
