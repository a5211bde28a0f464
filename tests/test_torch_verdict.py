"""The port's verdict contract (mine_tpu_torch/utils/verdict.py) prints what
the JAX package's (mine_tpu/utils/verdict.py) prints, on the same streams,
with the same exit codes."""

import pytest

from mine_tpu.utils import verdict as jax_verdict
from mine_tpu_torch.utils import verdict

VERDICTS = [
    {"metric": "m", "value": 1.5, "ok": True},
    {"metric": "m", "value": None, "ok": False, "rows": [{"a": 1}, {"b": [1, 2]}]},
    {"metric": "m", "ok": 1, "nested": {"x": "y"}},
    {"metric": "m"},  # no ok: a failing verdict
]


@pytest.mark.parametrize("v", VERDICTS)
def test_emit_prints_one_line_and_returns_the_same_code(v, capsys):
    got = verdict.emit(v)
    out = capsys.readouterr()
    want = jax_verdict.emit(v)
    ref = capsys.readouterr()
    assert got == want == (0 if v.get("ok") else 1)
    assert out.out == ref.out and out.out.count("\n") == 1 and out.err == ref.err == ""


def test_emit_failure_prints_the_traceback_and_a_failing_line(capsys):
    def fail():
        raise ValueError("x" * 3000)

    results = []
    for module in (verdict, jax_verdict):
        try:
            fail()
        except ValueError as exc:
            code = module.emit_failure("quality", exc, steps=3, dtype="float32")
        results.append((code, capsys.readouterr()))
    (got, out), (want, ref) = results
    assert got == want == 1
    assert out.out == ref.out and out.out.count("\n") == 1
    assert '"ok": false' in out.out and '"steps": 3' in out.out
    assert len(out.out) < 2200  # the error text is cut at 2000 characters
    assert out.err == ref.err and "Traceback" in out.err and "ValueError" in out.err
