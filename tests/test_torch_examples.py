"""The port's examples (``repro_torch.examples``) vs their JAX twins.

``quickstart`` runs at its own size in both packages here: the twin
(``examples/quickstart.py``) in process, its printed text equal to the
port's and to the recorded lines of ``repro_torch.examples.expected``.
``triangle_features_gnn`` runs at its own size in the port, held to the
recorded lines by ``expected.check``. The five other survey examples take
10–80 s each on the CPU at their own sizes, so each runs at a reduced
graph in both packages — the twin's own code with its generator call
shrunk, the port's ``run`` at the same size — and must print the same
lines: the four temporal ones on one shared ``temporal_social(200,
2000)``, the hub example on ``rmat(7, 8)``. Their cost is the twins'
JAX compiles, which barely shrink with the graph. At their own sizes they are held to the recorded lines on the card
(``chip_smoke.py``'s examples phase)."""
import contextlib
import importlib.util
import io
import re
import types
from pathlib import Path

import pytest
import torch

from repro.graphs import generators as ref_gen
from repro_torch.examples import NAMES, expected

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def twin(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_twin_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return buf.getvalue(), out


def port(name: str):
    return importlib.import_module(f"repro_torch.examples.{name}")


def test_recorded_lines_cover_every_example():
    assert set(expected.LINES) == set(NAMES)
    assert [len(t) for t in expected.GNN_STEP_LOSSES] == [60, 60]
    assert len(expected.TRAIN_LM_STEP_LOSSES) == 200


def test_quickstart_live_equal_twin_and_recorded_lines():
    text_ref, _ = printed(twin("quickstart").main)
    text, numbers = printed(port("quickstart").main, device="cpu")
    assert text == text_ref == expected.LINES["quickstart"]
    assert expected.check("quickstart", text, numbers) == []
    # the returned numbers are the printed ones
    for key in ("vertices", "edges", "wedges", "d_plus_max", "push_only",
                "push_entry_width", "push_pull"):
        assert re.search(rf"\b{numbers[key]}\b", text), key
    assert f"{numbers['reduction']:.1f}x" in text
    # and a changed line is reported
    assert expected.check("quickstart", text.replace(
        str(numbers["push_only"]), str(numbers["push_only"] + 1)), numbers)


def test_triangle_features_gnn_own_size_held_to_recorded_lines():
    text, numbers = printed(port("triangle_features_gnn").main, device="cpu")
    assert expected.check("triangle_features_gnn", text, numbers) == []
    assert text.splitlines()[0] == expected.LINES[
        "triangle_features_gnn"].splitlines()[0]
    assert all(s is None or s >= expected.TRACE_STEPS
               for s in expected.first_steps_past(numbers))
    assert numbers["vertices"] == 256 and len(numbers["base"]["step_s"]) == 60


# name -> (the twin's generator call, shrunk; the port's run arguments;
# the twin's literal text the shrink changes)
SHARED = ("temporal_social", (200, 2000), dict(n=200, m=2000), ())
REDUCED = {
    "closure_survey": SHARED,
    "label_survey": SHARED,
    "multi_survey": SHARED,
    "streaming_survey": SHARED,
    "hub_survey": ("rmat", (7,), dict(scale=7), (("rmat(12, 8)",
                                                  "rmat(7, 8)"),)),
}


@pytest.mark.parametrize("name", sorted(REDUCED))
def test_reduced_example_equal_twin(name):
    gen_name, size, kw, literals = REDUCED[name]
    mod = twin(name)
    real = getattr(ref_gen, gen_name)

    def shrunk(*args, **kwargs):
        return real(*size, *args[len(size):], **kwargs)

    mod.generators = types.SimpleNamespace(**{gen_name: shrunk})
    text_ref, _ = printed(mod.main)
    for old, new in literals:
        text_ref = text_ref.replace(old, new)
    text, numbers = printed(port(name).run, device="cpu", **kw)
    assert text == text_ref
    assert isinstance(numbers, dict) and numbers
