"""The port's lint pass (``repro_torch.analysis.lint``): each of the JAX
package's four rules, re-targeted at PyTorch idioms, catches a seeded
violation; integer evidence clears an integer scatter-add; host numpy
planning is out of scope; and the port's own tree is clean. Also the
report type, against the JAX package's."""
import textwrap

import pytest

from repro import analysis as ref_an
from repro_torch import analysis as pt_an
from repro_torch.analysis import check_kernel_oracles, lint_file, lint_repo


def codes(violations) -> set[str]:
    return {v.code for v in violations}


def _core_file(tmp_path, name, text):
    core = tmp_path / "core"
    core.mkdir(exist_ok=True)
    f = core / name
    f.write_text(textwrap.dedent(text))
    return f


def test_lint_catches_each_seeded_violation(tmp_path):
    f = _core_file(tmp_path, "bad.py", """\
        import torch

        class BadSurvey(Survey):
            def update(self, state, tri):
                w = tri.e_pq_f[:, 0]
                n = int(w.sum())
                return state

        def accum(hist, idx, w):
            wf = w.to(torch.float32)
            return hist.index_add_(0, idx, wf)

        def check(gr, cfg):
            if gr.epoch != cfg.epoch:
                raise ValueError("boom")
        """)
    assert codes(lint_file(f)) == {"fold-python-coercion",
                                   "float-scatter-accumulator",
                                   "provenance-direct-compare"}


@pytest.mark.parametrize("how", ["item", "tolist", "numpy", "float", "bool"])
def test_fold_coercion_catches_host_reads(tmp_path, how):
    call = (f"tri.valid.sum().{how}()" if how in ("item", "tolist", "numpy")
            else f"{how}(tri.valid.sum())")
    f = _core_file(tmp_path, "coerce.py", f"""\
        class S(Survey):
            def merge_epochs(self, prev, tri):
                x = {call}
                return prev
        """)
    [v] = lint_file(f)
    assert v.code == "fold-python-coercion" and v.where.endswith(":3")


SCATTERS = {
    "index_add_": "acc.index_add_(0, idx, {v})",
    "scatter_add": "acc.scatter_add(0, idx, {v})",
    "torch.scatter_add": "torch.scatter_add(acc, 0, idx, {v})",
    "scatter_reduce_sum": "acc.scatter_reduce_(0, idx, {v}, 'sum')",
    "index_put_accumulate": "acc.index_put_((idx,), {v}, accumulate=True)",
    "bincount_weights": "torch.bincount(idx, weights={v})",
}


@pytest.mark.parametrize("form", sorted(SCATTERS))
def test_float_scatter_forms_are_caught_and_int_evidence_clears(tmp_path,
                                                                form):
    """Each scatter-add spelling: a float32 operand is flagged, an int32
    one is not."""
    for dtype, want in (("float32", {"float-scatter-accumulator"}),
                        ("int32", set())):
        f = _core_file(tmp_path, "sc.py", f"""\
            import torch

            def fold(acc, idx, w):
                v = w.to(torch.{dtype})
                return {SCATTERS[form].format(v="v")}
            """)
        assert codes(lint_file(f)) == want, (form, dtype)


def test_int_evidence_on_the_accumulator_and_exempt_forms(tmp_path):
    """index_add_ into an int32 table with an operand of unknown dtype is
    proven by the accumulator; an amax scatter_reduce is no scatter-add;
    np.bincount with weights is host planning (out of scope); an
    accumulator with no evidence anywhere is reported as unprovable."""
    f = _core_file(tmp_path, "ok.py", """\
        import numpy as np
        import torch

        def fold(idx, amounts, w, n):
            t = torch.zeros(n, dtype=torch.int32).index_add_(0, idx, amounts)
            m = t.scatter_reduce(0, idx, w, "amax")
            h = np.bincount(idx, weights=w, minlength=n)
            return t, m, h
        """)
    assert lint_file(f) == []
    g = _core_file(tmp_path, "unknown.py", """\
        def fold(acc, idx, amounts):
            return acc.index_add_(0, idx, amounts)
        """)
    [v] = lint_file(g)
    assert v.code == "float-scatter-accumulator"
    assert "cannot statically prove" in v.message


def test_provenance_compare_allowed_in_the_helpers(tmp_path):
    f = tmp_path / "engine.py"
    f.write_text(textwrap.dedent("""\
        def _check_provenance(gr, cfg):
            return gr.hub_theta != cfg.hub_theta

        def elsewhere(gr, cfg):
            return gr.sample_p == cfg.sample_p
        """))
    [v] = lint_file(f)
    assert v.code == "provenance-direct-compare" and v.where.endswith(":5")


def test_kernel_oracle_rule(tmp_path):
    k = tmp_path / "kernels"
    csrc = tmp_path / "csrc"
    (k / "mykern").mkdir(parents=True)
    csrc.mkdir()
    (csrc / "mykern.cu").write_text("// kernel\n")
    (csrc / "orphan.cu").write_text("// kernel\n")
    (k / "mykern" / "ops.py").write_text(textwrap.dedent("""\
        from repro_torch.kernels import _cuda

        def mykern(x):
            return _cuda.function("mykern", "tripoll_mykern", [])(x)
        """))
    v = check_kernel_oracles(k)
    assert codes(v) == {"kernel-missing-oracle"}
    where = sorted(x.where for x in v)
    assert where == sorted([str(k / "mykern"), str(k / "mykern" / "ops.py"),
                            str(csrc / "orphan.cu")])
    (k / "mykern" / "ref.py").write_text("def ref(): pass\n")
    with (k / "mykern" / "ops.py").open("a") as fh:
        fh.write("\n\ndef mykern_plain(x):\n    return x\n")
    (csrc / "orphan.cu").unlink()
    assert check_kernel_oracles(k) == []


def test_port_lint_is_clean():
    assert lint_repo() == []


def test_report_formatting_equals_reference():
    args = ("lint", "some-code", "here", "msg")
    v = pt_an.Violation(*args)
    assert str(v) == str(ref_an.Violation(*args)) == "[lint:some-code] here: msg"
    assert (pt_an.format_report([v]) == ref_an.format_report(
        [ref_an.Violation(*args)]))
    assert pt_an.format_report([]) == "OK: no violations"
