"""The port's end-to-end examples on the CPU, at small steps and corpora:
``repro_torch.train.instruction_tune`` (port of
``examples/instruction_tune.py``) and ``repro_torch.train.serve_multitask``
(port of ``examples/serve_multitask.py``).

  * instruction_tune: PEQA tuning brings the instruction perplexity below
    the RTN 3-bit one, the codes stay bit-identical, the exported npz
    reloads equal to the model's scales, the optimizer state is 8 bytes a
    trainable scale, and a second run on the same checkpoint directory
    resumes from the last checkpoint;
  * serve_multitask: the two tasks' continuations of one prompt differ,
    and switching back to a task gives its continuation again.
"""
import math


from repro_torch.train import instruction_tune, serve_multitask
from _torch_threads import _one_torch_thread  # noqa: F401


SMALL = dict(steps=30, pretrain_steps=30, n_pretrain_tokens=40_000,
             n_instruction_tokens=20_000, seq=64, batch=4)


def test_instruction_tune_small(tmp_path):
    kw = dict(SMALL, ckpt_dir=str(tmp_path / "ckpt"),
              scale_bank=str(tmp_path / "bank"))
    lines = []
    out = instruction_tune.run("cpu", log=lines.append, **kw)
    assert out["model"] == "llama3.2-20m"
    for key in ("fp_ppl", "fp_instruction_ppl", "rtn_ppl", "tuned_ppl"):
        assert math.isfinite(out[key]) and out[key] > 1, key
    assert out["tuned_ppl"] < out["rtn_ppl"]
    assert out["codes_frozen"] and out["export_reloads_equal"]
    assert out["resumed_from"] is None
    assert out["state_bytes"] == 8 * out["trainable"]
    assert out["scale_bytes"] == 4 * out["trainable"]
    assert (tmp_path / "bank" / "instruction-v1.npz").exists()
    assert any(line.startswith("[eg] RTN 3-bit") for line in lines)
    again = instruction_tune.run("cpu", log=lambda m: None, **kw)
    assert again["resumed_from"] == SMALL["steps"]
    assert again["tuned_ppl"] == out["tuned_ppl"]
    assert again["codes_frozen"] and again["export_reloads_equal"]


def test_serve_multitask_small():
    out = serve_multitask.run("cpu", steps=40, n_tokens=20_000,
                              log=lambda m: None)
    assert out["tasks_differ"]
    assert [s["task"] for s in out["switches"]] == ["taskA", "taskB", "taskA"]
    gen = [s["generated"] for s in out["switches"]]
    assert gen[0] == gen[2] and gen[0] != gen[1]
    assert all(len(g) == 12 for g in gen)
    assert out["scale_bytes"]["taskA"] == out["scale_bytes"]["taskB"] > 0
