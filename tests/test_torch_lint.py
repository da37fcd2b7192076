"""The port's lint (``repro_torch.analysis.lint``) beside the JAX package's
``repro.analysis.lint``: paired snippets — a JAX call and its port call at
the same path — get the same rule id from both; the same scopes, the same
``# lint: allow`` marker; and ``lint_tree()`` over ``src/repro_torch`` is
clean. Rule ids and locations are compared exactly.
"""
import pathlib

import pytest

from repro.analysis import lint as jlint
from repro_torch.analysis import lint as tlint

# (relpath, JAX call, the port's call, the rule both must raise, or None)
PAIRS = [
    ("launch/steps.py", "float(loss)", "float(loss)", "LN001"),
    ("launch/steps.py", "jax.device_get(x)", "x.item()", "LN001"),
    ("launch/metrics.py", "np.asarray(x)", "np.asarray(x)", "LN001"),
    ("launch/metrics.py", "x.block_until_ready()", "x.tolist()", "LN001"),
    ("api/trainer.py", "jax.block_until_ready(x)", "torch.cuda.synchronize()", "LN001"),
    ("api/callbacks.py", "np.array(x)", "x.detach().cpu()", "LN001"),
    ("launch/evaluate.py", "jax.device_get(x)", "x.numpy()", "LN001"),
    ("resilience/guard.py", "float(x)", "x.item()", "LN001"),
    ("core/maxvol.py", "float(x)", "x.item()", None),           # not a hot-path module
    ("selection/graft.py", "time.perf_counter()", "time.perf_counter()", "LN002"),
    ("kernels/graft_select.py", "time.time()", "time.time()", "LN002"),
    ("launch/steps.py", "time.monotonic()", "time.monotonic()", "LN002"),
    ("api/trainer.py", "time.perf_counter()", "time.perf_counter()", None),
    ("models/layers.py", "pl.pallas_call(k)(x)", "build.call(fn, 'k', dev, (), ())", "LN003"),
    ("selection/engine.py", "pallas_call(k)", "ctypes.CDLL('lib.so')", "LN003"),
    ("core/maxvol.py", "pl.pallas_call(k)", "gs.launchers()", "LN003"),
    ("launch/steps.py", "pl.pallas_call(k)", "build.load('graft_select')", "LN003"),
    ("kernels/ops.py", "pl.pallas_call(k)", "build.call(fn, 'k', dev, (), ())", None),
    ("selection/engine.py", "jax.make_mesh((1,), ('x',))",
     "init_device_mesh('cuda', (1,))", "LN004"),
    ("api/trainer.py", "jax.distributed.initialize()",
     "torch.distributed.init_process_group('gloo')", "LN004"),
    ("distributed/accumulate.py", "Mesh(devs, ('x',))", "DeviceMesh('cuda', [0])", "LN004"),
    ("backend/local.py", "jax.distributed.initialize()",
     "torch.distributed.init_process_group('gloo')", None),
]


def _rules(findings):
    return [(f.rule, f.location) for f in findings]


@pytest.mark.parametrize("relpath,jax_call,port_call,rule", PAIRS)
def test_paired_calls_get_the_same_rule(relpath, jax_call, port_call, rule):
    src = "def f(x):\n    return {}\n"
    want = jlint.lint_source(src.format(jax_call), relpath)
    got = tlint.lint_source(src.format(port_call), relpath)
    assert _rules(got) == _rules(want)
    assert _rules(got) == ([] if rule is None else [(rule, f"{relpath}:2")])


@pytest.mark.parametrize("relpath,jax_call,port_call,rule", [p for p in PAIRS if p[3]])
def test_allow_marker_whitelists_the_line_and_the_next(relpath, jax_call, port_call, rule):
    for src in ("def f(x):\n    return {}  # lint: allow drain point\n",
                "def f(x):\n    # lint: allow drain point\n    return {}\n"):
        assert jlint.lint_source(src.format(jax_call), relpath) == []
        assert tlint.lint_source(src.format(port_call), relpath) == []


def test_scopes_and_marker_equal_jax():
    assert tlint.ALLOW_MARKER == jlint.ALLOW_MARKER
    assert tlint.HOT_PATH_MODULES == jlint.HOT_PATH_MODULES
    assert tlint.DISPATCH_CLOCK_SCOPES == jlint.DISPATCH_CLOCK_SCOPES


def test_unparseable_module_is_reported_by_both():
    want = jlint.lint_source("def f(:\n", "launch/steps.py")
    got = tlint.lint_source("def f(:\n", "launch/steps.py")
    assert _rules(got) == _rules(want) == [("LN001", "launch/steps.py:1")]


def test_lint_tree_clean_on_the_port():
    report = tlint.lint_tree()
    assert report.ok, report.format()
    root = pathlib.Path(tlint.__file__).resolve().parent.parent
    assert root.name == "repro_torch"
    # the sanctioned drain points carry the marker beside sync_allowed
    for rel, site in (("launch/steps.py", "sentinel"), ("api/trainer.py", "step_sync"),
                      ("launch/metrics.py", "metrics_flush")):
        text = (root / rel).read_text()
        assert f"lint: allow {site}" in text, rel
    # without the markers the drains are flagged
    bare = (root / "launch/steps.py").read_text().replace("# lint: allow", "#")
    assert [f.rule for f in tlint.lint_source(bare, "launch/steps.py")] == ["LN001", "LN001"]
