"""Run one of the JAX package's control-plane tests on both packages and
return what it did, so that the port's copy of ``repro.core`` can be held
against the reference bit for bit.

``run_case(pkg, "test_engine.py::test_x", ...)`` loads ``tests/test_engine.py``
from its source, for ``pkg="repro_torch"`` with every ``repro.`` import
turned into ``repro_torch.``, and calls ``test_x`` with its fixtures. The
test's own asserts run against that package. Meanwhile every ``Query``
created, every pool quote and every price menu is recorded, and the result
is a plain-data snapshot of all of it: per query its relative qid, times,
cluster, chip-seconds, cost, stage trace, preemptions, spills, retries and
fusion; per quote its numbers. Equal snapshots (``==``) mean equal results.

The port's hardware default is the H100 and the reference's the TPU v5e:
``check_case`` binds the default ``hw`` of one package to the other's spec
while the case runs, so both packages compute with the same spec (the
port's ``V5E`` equals the reference's field for field; the reference's
code reads the port's ``H100`` as it reads its own specs).

A case may name one parametrization of a parametrized test as
``"file.py::test_x[id]"``, where ``id`` joins the parameter values with
"-" in the order the marks were applied (``_param_sets``). Both packages
restart their qid counter before a case (the reference's tests may call
``reset_qids`` themselves), and a hypothesis test draws derandomized
examples, so both packages see the same ones.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import importlib
import inspect
import itertools
import re
import types
from pathlib import Path

import pytest
from hypothesis import settings

TESTS = Path(__file__).resolve().parent
settings.register_profile("_parity", derandomize=True, database=None)


def _port_source(src: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", src)


@contextlib.contextmanager
def _derandomized():
    """Hypothesis settings created meanwhile derandomize their examples."""
    prev = settings._current_profile
    settings.load_profile("_parity")
    try:
        yield
    finally:
        settings.load_profile(prev)


def load_case_module(filename: str, pkg: str) -> types.ModuleType:
    """``tests/<filename>`` executed as a fresh module against ``pkg``."""
    src = (TESTS / filename).read_text()
    if pkg == "repro_torch":
        src = _port_source(src)
    name = f"_parity_{pkg}_{Path(filename).stem}"
    mod = types.ModuleType(name)
    mod.__file__ = str(TESTS / filename)
    with _derandomized():
        exec(compile(src, str(TESTS / filename), "exec"), mod.__dict__)
    return mod


def _param_sets(fn) -> dict:
    """``{id: kwargs}`` of every parametrization of ``fn`` (``{"": {}}``
    when it has none). Stacked marks combine as pytest combines them."""
    marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
    axes = []
    for m in marks:
        names = [n.strip() for n in m.args[0].split(",")] if isinstance(m.args[0], str) \
            else list(m.args[0])
        axes.append([dict(zip(names, v if len(names) > 1 else (v,))) for v in m.args[1]])
    out = {}
    for combo in itertools.product(*axes):
        kw = {k: v for d in combo for k, v in d.items()}
        out["-".join(str(v) for d in combo for v in d.values())] = kw
    return out


def _functions(module):
    for obj in vars(module).values():
        if inspect.isfunction(obj) and obj.__module__ == module.__name__:
            yield obj
        elif inspect.isclass(obj) and obj.__module__ == module.__name__:
            yield from (v for v in vars(obj).values() if inspect.isfunction(v))


@contextlib.contextmanager
def hw_defaults(pkg: str, spec):
    """Bind every default ``hw`` of ``pkg``'s core (the package's own
    default spec) to ``spec`` for the duration."""
    hw = importlib.import_module(f"{pkg}.perf.hw")
    old_spec = hw.H100 if pkg == "repro_torch" else hw.V5E
    saved = []
    for mname in ("cost_model", "clusters", "pools", "calibration"):
        for fn in _functions(importlib.import_module(f"{pkg}.core.{mname}")):
            d, kw = fn.__defaults__, fn.__kwdefaults__
            saved.append((fn, d, kw))
            if d:
                fn.__defaults__ = tuple(spec if v is old_spec else v for v in d)
            if kw:
                fn.__kwdefaults__ = {k: spec if v is old_spec else v for k, v in kw.items()}
    try:
        yield
    finally:
        for fn, d, kw in saved:
            fn.__defaults__, fn.__kwdefaults__ = d, kw


def _plain(v, base):
    """Plain data of a recorded value: queries by relative qid, enums by
    name, named tuples and dataclasses by their fields."""
    q_cls = type(v).__name__ == "Query" and hasattr(v, "qid")
    if q_cls:
        return ("Q", v.qid - base)
    if isinstance(v, enum.Enum):
        return v.name
    if hasattr(v, "_fields"):  # StageEvent
        d = v._asdict()
        if "qid" in d:
            d["qid"] -= base
        return tuple((k, _plain(x, base)) for k, x in d.items())
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return tuple((f.name, _plain(getattr(v, f.name), base))
                     for f in dataclasses.fields(v))
    if isinstance(v, dict):
        return tuple(sorted((str(k), _plain(x, base)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x, base) for x in v)
    return v


QUERY_FIELDS = ("sla", "effective_sla", "state", "submit_time", "dequeue_time",
                "start_time", "finish_time", "cluster", "chip_seconds", "cost",
                "stage_cursor", "stage_trace", "preemptions", "spilled",
                "spill_backs", "retries", "fused_with", "members", "error")


def _snapshot(q, base):
    out = [("qid", q.qid - base), ("work", _plain(q.work, base))]
    for f in QUERY_FIELDS:
        if hasattr(q, f):
            out.append((f, _plain(getattr(q, f), base)))
    return tuple(out)


def _quote_classes(core):
    for mname in ("engine", "clusters"):
        mod = importlib.import_module(f"{core.__name__}.{mname}")
        for obj in vars(mod).values():
            if inspect.isclass(obj) and obj.__module__ == mod.__name__ and "quote" in vars(obj):
                yield obj


def _fixture_value(module, name, stack, tmp_path, monkeypatch):
    if name == "tmp_path":
        tmp_path.mkdir(parents=True, exist_ok=True)
        return tmp_path
    if name == "monkeypatch":
        return monkeypatch
    if name == "update_golden":  # tests/conftest.py: never rewrite a golden file here
        return False
    fx = getattr(module, name)
    gen = fx._get_wrapped_function()()
    if inspect.isgenerator(gen):
        value = next(gen)
        stack.callback(lambda: next(gen, None))
        return value
    return gen


def run_case(pkg: str, case: str, tmp_path: Path, hw=None):
    """Run ``case`` ("file.py::test_name") against ``pkg``, with ``hw`` in
    place of the package's default spec where given; return its recorded
    snapshot (see the module docstring)."""
    filename, test_name = case.split("::")
    test_name, _, param_id = test_name.partition("[")
    core = importlib.import_module(f"{pkg}.core")
    query_mod = importlib.import_module(f"{pkg}.core.query")
    query_mod.reset_qids()
    insights = importlib.import_module(f"{pkg}.core.insights")
    made, quotes, menus = [], [], []
    with contextlib.ExitStack() as stack:
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        if hw is not None:
            stack.enter_context(hw_defaults(pkg, hw))
        base = query_mod.Query(work=query_mod.QueryWork(), sla=None, submit_time=0.0).qid + 1
        init = query_mod.Query.__init__

        def recording_init(self, *a, **kw):
            init(self, *a, **kw)
            made.append(self)

        mp.setattr(query_mod.Query, "__init__", recording_init)
        for cls in _quote_classes(core):
            def recording_quote(self, q, *a, _orig=vars(cls)["quote"], **kw):
                out = _orig(self, q, *a, **kw)
                quotes.append((type(self).__name__, q.qid - base, _plain(out, base)))
                return out
            mp.setattr(cls, "quote", recording_quote)
        menu = insights.price_menu

        def recording_menu(*a, **kw):
            out = menu(*a, **kw)
            menus.append(_plain(out, base))
            return out

        mp.setattr(insights, "price_menu", recording_menu)
        mp.setattr(core, "price_menu", recording_menu)
        module = load_case_module(filename, pkg)
        fn = getattr(module, test_name)
        fixtures = _param_sets(fn)[param_id.rstrip("]")]
        inner_mp = stack.enter_context(pytest.MonkeyPatch.context())
        for p in inspect.signature(fn).parameters:
            if p not in fixtures:
                fixtures[p] = _fixture_value(module, p, stack, tmp_path, inner_mp)
        fn(**fixtures)
        return {
            "queries": [_snapshot(q, base) for q in made],
            "quotes": quotes,
            "menus": menus,
        }


def check_case(case: str, tmp_path: Path, spec: str = "V5E") -> None:
    """The case passes on both packages, both computing with the port's
    ``spec`` ("V5E" or "H100", from ``repro_torch.perf.hw``), and records
    equal results."""
    hw = getattr(importlib.import_module("repro_torch.perf.hw"), spec)
    ref = run_case("repro", case, tmp_path / "ref", hw=None if spec == "V5E" else hw)
    port = run_case("repro_torch", case, tmp_path / "port", hw=None if spec == "H100" else hw)
    assert port["queries"] == ref["queries"]
    assert port["quotes"] == ref["quotes"]
    assert port["menus"] == ref["menus"]
