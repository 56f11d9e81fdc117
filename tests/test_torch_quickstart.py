"""The graph examples' ports (``examples/quickstart_torch.py``,
``examples/fraud_detection_torch.py``) run end to end on the CPU.

The quickstart is held to the lines ``tests/test_quickstart.py`` asserts
of the JAX package's quickstart; the fraud-detection scenario prints the
same lines as the JAX package's (graph size, degree outliers, hottest
items), apart from its timings.
"""
import importlib.util
import pathlib
import re

_EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  _EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_runs_end_to_end(capsys):
    _load("quickstart_torch").main(sf=1, device="cpu")
    out = capsys.readouterr().out
    assert "cache_hit=True" in out
    assert "pagerank (csr_cache_hit=True" in out
    assert "weakly connected components:" in out
    # the mutate-then-refresh step took the delta path and stayed exact
    assert "refresh path=delta" in out
    assert "refreshed analyze matches cold engine: True" in out
    # step 8: discovery proposed a model and it extracted non-trivially
    assert "all_compiled=True" in out
    assert "accepted top-3 spec, extracted:" in out
    assert "degree_stats over the discovered graph:" in out


def _results(out):
    """The printed lines that carry results, without timings and the
    plan's verbose dump."""
    keep = ("graph:", "degree outliers", "   customer id=", "hottest items")
    return [re.sub(r"\d+\.\d+s", "", line) for line in out.splitlines()
            if line.startswith(keep)]


def test_fraud_detection_torch_prints_what_jax_prints(capsys):
    _load("fraud_detection").main()
    want = _results(capsys.readouterr().out)
    _load("fraud_detection_torch").main(device="cpu")
    got = _results(capsys.readouterr().out)
    assert len(want) == 8 and got == want
