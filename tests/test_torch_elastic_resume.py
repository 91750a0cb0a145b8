"""Resume of the port's training driver, on the CPU.

``run_dlrm`` runs 6 steps of wdl-tiny (4 workers of 8, alpha 1, the
ragged exchange) under the elastic slice's fault plan with
``--ckpt-every 3``; resumed from its step-3 checkpoint (the step-6 one
removed), it gives the uninterrupted records from step 3 on exactly:
losses, cache counts, their cost, the Alg.-1 estimate and ``n_active``.
At depth 2 a step's record is built a drain after the next step's train
has updated the parameters in place, so this is what shows that a
checkpoint holds the parameters of the step it names.  With ``--codec
int8`` the checkpoint carries the codec's residual too.  ``run_lm``
resumes the same way (its parity with the reference's checkpoint
layout is tests/test_torch_checkpoint.py).

Each test runs on one CPU thread: with several, a threaded reduction of
the train step sums in an order that varies from run to run, and the
last bits of a loss move even between two uninterrupted runs (on the
card the runs repeat bit for bit: tests/test_torch_elastic_cuda.py).
"""
import pytest
import torch

from repro_torch.launch.train import main

ARCH, N, M, STEPS = "wdl-tiny", 4, 8, 6
PLAN = "straggle@1:0x4-3; crash@2:1g; bw@3:2x0.25-5; rejoin@3:1w"
KEYS = ("loss", "miss_pull", "update_push", "evict_push", "cost",
        "alg1_est", "n_active")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(metrics, keys=KEYS):
    return [[r["step"]] + [r[k] for k in keys] for r in metrics]


def _interrupted(argv, tmp_path, every, steps):
    full = main(argv)["metrics"]
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"ckpt_{s:08d}.npz" for s in range(every, steps + 1,
                                                          every)]
    (tmp_path / names[-1]).unlink()    # the run was cut before its end
    return full, main(argv + ["--resume"])["metrics"]


@pytest.mark.parametrize("depth,codec", [("1", None), ("2", None),
                                         ("2", "int8")])
def test_resume_continues_exactly(tmp_path, depth, codec):
    argv = ["--arch", ARCH, "--workers", str(N), "--batch-per-worker",
            str(M), "--steps", str(STEPS), "--esd-alpha", "1", "--exchange",
            "ragged", "--device", "cpu", "--fault-plan", PLAN,
            "--pipeline-depth", depth, "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3"] + (["--codec", codec] if codec else [])
    full, resumed = _interrupted(argv, tmp_path, 3, STEPS)
    assert [r["step"] for r in resumed] == [3, 4, 5]
    assert _records(resumed) == _records(full[3:])


def test_lm_resume_continues_exactly(tmp_path):
    argv = ["--arch", "smollm-360m", "--smoke", "--seq-len", "16",
            "--batch-per-worker", "2", "--steps", "2", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    full, resumed = _interrupted(argv, tmp_path, 1, 2)
    assert [r["step"] for r in resumed] == [1]
    assert _records(resumed, ("loss",)) == _records(full[1:], ("loss",))
