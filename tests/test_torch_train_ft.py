"""The port's fault-tolerant training demo (``repro_torch.launch.train_ft``,
the counterpart of examples/train_ft.py) on the CPU: the crash at step 13
and the resume from step 10's checkpoint give the losses and the final
state of an uninterrupted run, exactly."""
import pytest
import torch

from repro_torch.launch import train_ft
from repro_torch.launch.train import train
from repro_torch.models.params import tree_leaves


def test_resumed_losses_equal_an_uninterrupted_run(tmp_path, capsys):
    out = train_ft.main(["--device", "cpu", "--ckpt-dir", str(tmp_path / "ft")])
    ref = train("qwen2-0.5b", steps=20, batch=4, seq=32, ckpt_every=5, log_every=5,
                ckpt_dir=str(tmp_path / "ref"), device="cpu")
    assert train_ft.FAIL_AT == 13 and out["steps_run"] == 10  # resumed at step 10
    assert out["losses"] == ref["losses"][10:]
    for a, b in zip(tree_leaves(out["state"]), tree_leaves(ref["state"])):
        assert torch.equal(a, b)
    printed = capsys.readouterr().out
    assert "injected failure at step 13" in printed
    assert "resumed from step 10" in printed
    assert not (tmp_path / "ft").exists()  # the demo cleans up after itself


def test_train_ft_asks_for_cuda_and_raises_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ft.main(["--ckpt-dir", str(tmp_path / "ft")])
    assert not (tmp_path / "ft").exists()
