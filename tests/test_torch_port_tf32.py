"""The TF32 flags of two generators interleaved through one device lock, on
the CPU (cgd_tpu_torch/api.py ``_TF32Off``).

cuDNN's and cuBLAS's TF32 flags are process-global. An f32 run turns them
off and puts back what it found. Run A (f32) holds the device lock and
samples while run B starts: had B saved the flags at its own start, it would
save A's "off", A would put back "on" at its next yield, and B would then
sample at TF32, its result silently outside the f32 bound. The port lets
only the lock's holder set the flags (an f32 run takes the lock before its
prompt encoding), so every f32 conv and dense call of either run sees both
flags off, and the caller's flags are back after both. Recorded at the f32
conv / dense wrappers (``kernels.conv3x3.conv3x3_fwd`` / ``conv3x3_dx``,
``ops.nn.dense``) with the interleaving forced: A waits at its first
sampling call until B has started. Tolerance: none (flags are compared
exactly)."""

import threading

import pytest

torch = pytest.importorskip("torch")

from cgd_tpu_torch import api  # noqa: E402
from cgd_tpu_torch.kernels import conv3x3 as k3  # noqa: E402
from cgd_tpu_torch.ops import nn as cnn  # noqa: E402

torch.set_num_threads(2)

KW = dict(prompts=["flags"], image_size=64, num_cutouts=2, timestep_respacing="ddim4",
          weights_mode="random", device="cpu", progress=False, save_frequency=2)


@pytest.mark.parametrize("dtypes", [("float32", "float32"), ("float32", "bfloat16"),
                                    ("bfloat16", "float32")], ids="+".join)
def test_two_generators_through_one_lock_keep_tf32_off_for_every_f32_call(
        monkeypatch, tmp_path, dtypes):
    monkeypatch.setenv("CGD_TPU_DEBUG_TINY", "1")
    monkeypatch.chdir(tmp_path)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    a_sampling, b_started = threading.Event(), threading.Event()
    calls = []  # (run, cudnn.allow_tf32, matmul.allow_tf32) at every f32 call

    def recorded(real, pos):
        def call(*args, **kw):
            name = threading.current_thread().name
            if args[pos].dtype == torch.float32 and name in ("A", "B"):
                if name == "A" and a_sampling.is_set() and not b_started.is_set():
                    assert b_started.wait(60), "run B never started"
                calls.append((name, cudnn.allow_tf32, matmul.allow_tf32))
            return real(*args, **kw)
        return call

    monkeypatch.setattr(k3, "conv3x3_fwd", recorded(k3.conv3x3_fwd, 0))
    monkeypatch.setattr(k3, "conv3x3_dx", recorded(k3.conv3x3_dx, 0))
    monkeypatch.setattr(cnn, "dense", recorded(cnn.dense, 1))

    def pet_a(phase):
        if phase == "compile + first sampling segment":
            a_sampling.set()

    def pet_b(phase):
        if phase == "resolve model checkpoints":
            b_started.set()

    lock, errors, frames = threading.Lock(), [], {}

    def run(name, dtype, pet):
        try:
            frames[name] = list(api.clip_guided_diffusion(
                **KW, compute_dtype=dtype, prefix_path=tmp_path / name, stall_pet=pet,
                device_lock=lock))
        except BaseException as e:  # pragma: no cover - reported below
            errors.append(e)
            b_started.set()

    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        a = threading.Thread(target=run, args=("A", dtypes[0], pet_a), name="A")
        b = threading.Thread(target=run, args=("B", dtypes[1], pet_b), name="B")
        a.start()
        assert a_sampling.wait(120), "run A never reached its sampling"
        b.start()
        a.join(300)
        b.join(300)
        after = cudnn.allow_tf32, matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev
    assert not errors, errors
    assert len(frames["A"]) == len(frames["B"]) == 3
    for name, dtype in zip("AB", dtypes):
        mine = [(c, m) for who, c, m in calls if who == name]
        if dtype == "float32":
            assert mine and set(mine) == {(False, False)}, (name, sorted(set(mine)))
    assert after == (True, True)
