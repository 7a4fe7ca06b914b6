"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU at a
reduced size: its records are what ``fit_dryruns`` reads, the hw tag keeps
them apart from other hardware's, the depth extrapolation is exact on a
linear model, it refuses to run without a card unless asked for the CPU,
and its input specs (``data/batches.py``) are the shapes ``make_batch``
and the reference's specs give."""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.calibration as ref_calibration
from repro.data import batches as ref_batches
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.calibration import fit_dryruns
from repro_torch.core.cost_model import _analytic_step
from repro_torch.data.batches import make_batch, prefill_specs, train_specs
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES, ShapeCell
from repro_torch.perf.hw import H100, V5E

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "dryrun"


@pytest.fixture(scope="module")
def records():
    """Records of three reduced cells measured on the CPU: two serve, one
    train."""
    return [dryrun.measure_cell("qwen2-0.5b", device="cpu", reduced=True, tokens=64),
            dryrun.measure_cell("mixtral-8x7b", device="cpu", reduced=True, tokens=64),
            dryrun.measure_cell("qwen2-0.5b", "train", device="cpu", reduced=True, tokens=128)]


def test_records_carry_the_schema_fit_dryruns_reads(records, tmp_path):
    paths = [dryrun.write_record(r, tmp_path) for r in records]
    assert [p.name for p in paths] == ["qwen2-0.5b__prefill_64__1__h100.json",
                                       "mixtral-8x7b__prefill_64__1__h100.json",
                                       "qwen2-0.5b__train_128__1__h100.json"]
    for p, rec in zip(paths, records):
        got = json.loads(p.read_text())
        assert got == rec
        assert got["status"] == "ok" and got["hw"] == "h100" and got["chips"] == 1
        assert got["mesh"] == "1" and got["device"] == "cpu" and got["config"] == "reduced"
        assert len(got["measured_ms"]) == 3
        assert got["roofline"]["terms"]["step_s"] == pytest.approx(
            float(np.median(got["measured_ms"])) / 1e3, rel=1e-12)
        assert got["analytic_s"] == _analytic_step(get_config(got["arch"]), got["tokens"],
                                                   got["kind"], chips=1, hw=H100)
    table = fit_dryruns(tmp_path, hw=H100, hw_tag="h100")
    assert table.source.endswith("(3 records)")  # nothing skipped
    assert set(table.as_dict()["factors"]) == {
        "qwen2-0.5b/serve", "mixtral-8x7b/serve", "qwen2-0.5b/train"}
    # the reference's fit reads the same records to the same table
    want = ref_calibration.fit_dryruns(tmp_path, hw=H100, hw_tag="h100")
    assert table.as_dict()["factors"] == want.as_dict()["factors"]
    assert table.speed_factor == want.speed_factor


def test_a_mixed_directory_is_filtered_by_the_tag(records, tmp_path):
    for rec in records:
        dryrun.write_record(rec, tmp_path)
    for p in FIXTURES.glob("*.json"):
        shutil.copy(p, tmp_path / p.name)
    ours = fit_dryruns(tmp_path, hw=H100, hw_tag="h100")
    theirs = fit_dryruns(tmp_path, hw=V5E, hw_tag="fixture-cpu")
    assert ours.source.endswith("(3 records)")
    assert theirs.source.endswith("(4 records)")
    assert "paper-default/serve" in theirs.as_dict()["factors"]
    assert "paper-default/serve" not in ours.as_dict()["factors"]
    alone = fit_dryruns(FIXTURES, hw=V5E, hw_tag="fixture-cpu")
    assert theirs.as_dict()["factors"] == alone.as_dict()["factors"]
    assert theirs.speed_factor == alone.speed_factor


@pytest.mark.parametrize("d,L", [(2, 32), (1, 2), (4, 36)])
def test_depth_extrapolation_is_exact_for_a_linear_model(d, L):
    residual, per_layer = 0.5, 0.25
    t = {n: residual + n * per_layer for n in (d, 2 * d)}
    assert dryrun.extrapolate_depth(t[d], t[2 * d], d, L) == residual + L * per_layer


def test_depth_extrapolation_on_made_up_times():
    # 30 further layers at (4.0 - 3.0) / 2 s each, on top of depth 2's 3.0 s
    assert dryrun.extrapolate_depth(3.0, 4.0, 2, 32) == 18.0
    assert dryrun.extrapolate_depth(1.0, 1.0, 2, 32) == 1.0  # no per-layer time


def test_an_arch_over_one_card_is_cut_to_two_depths_and_extrapolated(monkeypatch):
    """mixtral-8x7b's float32 weights exceed one card: the cell is timed
    at depths 2 and 4 (here a made-up linear model, 500 ms + 250 ms a
    layer) and the record holds both times and the exact 32-layer step."""
    cfg = get_config("mixtral-8x7b")
    assert 4 * cfg.num_params() > dryrun.FIT_BYTES
    seen = []

    def fake_prefill_ms(cfg, tokens, device, repeats):
        seen.append(cfg.num_layers)
        return [500.0 + 250.0 * cfg.num_layers] * repeats

    monkeypatch.setattr(dryrun, "_prefill_ms", fake_prefill_ms)
    rec = dryrun.measure_cell("mixtral-8x7b", device="cpu")
    assert seen == [2, 4]
    assert rec["roofline"]["terms"]["step_s"] == 0.5 + 32 * 0.25
    assert rec["depth_step_s"] == {"2": 1.0, "4": 1.5}
    assert rec["measured_ms"] == {"2": [1000.0] * 3, "4": [1500.0] * 3}
    assert rec["reduced"] == "depth 2 and 4 of 32, extrapolated linearly"
    assert rec["shape"] == "prefill_4k" and rec["tokens"] == 4096
    seen.clear()
    rec = dryrun.measure_cell("granite-8b", device="cpu")  # 33 GB: full depth
    assert seen == [36] and "reduced" not in rec


def test_cuda_is_the_default_and_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.measure_cell("qwen2-0.5b", reduced=True, tokens=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "qwen2-0.5b", "--reduced", "--out", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []  # no record of a run that did not happen
    with pytest.raises(ValueError, match="at least 3"):
        dryrun.measure_cell("qwen2-0.5b", device="cpu", reduced=True, repeats=2)


def test_the_cli_writes_one_record_an_arch(tmp_path, capsys):
    paths = dryrun.main(["--arch", "qwen2-0.5b", "--arch", "granite-8b", "--reduced",
                         "--tokens", "32", "--device", "cpu", "--out", str(tmp_path)])
    assert [p.name for p in paths] == ["qwen2-0.5b__prefill_32__1__h100.json",
                                       "granite-8b__prefill_32__1__h100.json"]
    assert "ok qwen2-0.5b prefill_32" in capsys.readouterr().out
    assert dryrun.TABLE1_ARCHS == ("qwen2-0.5b", "internlm2-1.8b", "granite-8b",
                                   "mixtral-8x7b", "phi3.5-moe-42b-a6.6b")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-8b", "mixtral-8x7b", "mamba2-2.7b"])
def test_specs_give_the_shapes_of_make_batch(arch):
    cfg = get_config(arch, reduced=True)
    cell = ShapeCell("t", "train", 24, 3)
    batch = make_batch(np.random.default_rng(0), cfg, batch=3, seq=24, device="cpu")
    specs = train_specs(cfg, cell)
    assert specs.keys() == batch.keys()
    for k, t in batch.items():
        assert specs[k].shape == t.shape and specs[k].dtype == t.dtype
        assert specs[k].device.type == "meta"
    pre = prefill_specs(cfg, ShapeCell("p", "prefill", 24, 3))
    served = make_batch(np.random.default_rng(0), cfg, batch=3, seq=24, kind="prefill",
                        device="cpu")
    assert pre.keys() == served.keys()
    assert pre["tokens"].shape == served["tokens"].shape
    assert pre["tokens"].dtype == served["tokens"].dtype


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_specs_equal_the_references(arch, kind):
    """Every arch's specs, frontend and encoder inputs included, have the
    reference's leaves, shapes and dtypes."""
    from repro.configs import get_config as ref_get_config
    from repro.models.config import SHAPES as REF_SHAPES

    name = "train_4k" if kind == "train" else "prefill_32k"
    ours = (train_specs if kind == "train" else prefill_specs)(get_config(arch), SHAPES[name])
    theirs = (ref_batches.train_specs if kind == "train" else ref_batches.prefill_specs)(
        ref_get_config(arch), REF_SHAPES[name])
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert tuple(ours[k].shape) == tuple(theirs[k].shape)
        assert str(ours[k].dtype).removeprefix("torch.") == str(theirs[k].dtype)
