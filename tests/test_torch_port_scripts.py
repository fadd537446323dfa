"""Three of the JAX package's root scripts against their ports in
``ivit_tpu_torch/scripts/`` on the CPU (``--device cpu``).  JAX's scripts
are loaded by path (``scripts/`` is not a package) and left as they are;
their integer outputs are read by recording the arguments of the
functions they call.

* ``approx_analysis``: every function (GELU, softmax, exp, LayerNorm) and
  family (ivit, ibert, ppoly, ibert_int_sqrt): the outputs bitwise JAX's;
  the statistics exactly JAX's, but the softmax's within 1e-6 absolute:
  its golden is an f32 softmax in numpy where JAX's is ``jax.nn.softmax``,
  and the two differ in the last ulps (about 1.5e-8 here), which moves a
  statistic by as much.
* ``ppoly_sweep``: a 2 x 2 grid (deg 1, 2 x seg 8, 16) of both functions
  and both backends: every row JAX's, but GELU with the ibert backend, a
  divergence pinned here: the integers are JAX's, JAX's error (15,640 at
  deg 2, seg 16) is those integers times the table's ``out_scale``, and
  the port's (``y_int / 2**N``, as for every backend) is under 0.2.
* ``sweep``: the mini YAML reader equals PyYAML and JAX's on ``sweep.yaml``;
  ``--dry-run`` gives JAX's points, run ids and order; one point runs the
  port's training CLI on the CPU (64 px, 4 synthetic images) and leaves a
  summary line with return code 0 and its final epoch record.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import ivit_tpu.ops.ppoly as jax_ppoly
from ivit_tpu_torch.ops import ppoly as port_ppoly
from ivit_tpu_torch.scripts import approx_analysis, ppoly_sweep, sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["ivit", "ibert", "ppoly", "ibert_int_sqrt"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_approx():
    return _jax_script("approx_analysis")


@pytest.mark.parametrize("function", approx_analysis.FUNCTIONS)
def test_approx_analysis_matches_jax(jax_approx, monkeypatch, function):
    seen = []
    stats = jax_approx._err_stats

    def record(got, want):
        seen.append(np.asarray(got))
        return stats(got, want)

    monkeypatch.setattr(jax_approx, "_err_stats", record)
    want = getattr(jax_approx, f"analyze_{function}")(0.05, FAMILIES)
    out, _ = approx_analysis.outputs(function, 0.05, FAMILIES, "cpu")
    got = approx_analysis.analyze(function, 0.05, FAMILIES, "cpu")
    assert list(out) == list(want) == list(got) and len(seen) == len(out)
    for (fam, y), y_jax in zip(out.items(), seen):
        np.testing.assert_array_equal(y, y_jax, err_msg=fam)
    for fam in want:
        if function == "softmax":
            for k in want[fam]:
                assert abs(got[fam][k] - want[fam][k]) <= 1e-6, (fam, k)
        else:
            assert got[fam] == want[fam], fam


def test_approx_analysis_cli(tmp_path, capsys):
    out = tmp_path / "approx.json"
    res = approx_analysis.main(["--function", "exp", "--families", "ivit", "ibert",
                                "--device", "cpu", "--json", str(out)])
    assert json.loads(out.read_text()) == res and list(res) == ["exp"]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[0].startswith("exp        ivit       max ")


def _recorder(mod, seen, monkeypatch):
    fn = mod.eval_piecewise_poly

    def record(x, bounds, coeffs):
        y = fn(x, bounds, coeffs)
        seen.append(np.asarray(y))
        return y
    monkeypatch.setattr(mod, "eval_piecewise_poly", record)


@pytest.mark.parametrize("function,bits", [("gelu", 22), ("softmax", 28)])
def test_ppoly_sweep_matches_jax(monkeypatch, function, bits):
    jax_sweep = _jax_script("ppoly_sweep")
    grid = (function, 0.05, [1, 2], [8, 16], [bits], ["float", "ibert"], False)
    jax_ints, port_ints = [], []
    _recorder(jax_ppoly, jax_ints, monkeypatch)
    _recorder(port_ppoly, port_ints, monkeypatch)
    want = jax_sweep.sweep(*grid)
    got = ppoly_sweep.sweep(*grid, device="cpu")
    assert len(got) == len(want) == len(port_ints) == len(jax_ints) == 8
    x_int = np.arange(-128, 128, dtype=np.float32)
    for g, w, yp, yj in zip(got, want, port_ints, jax_ints):
        np.testing.assert_array_equal(yp, yj)
        if function == "gelu" and g["backend"] == "ibert":
            # the pinned divergence: JAX reads the integers at I-BERT's
            # composite scale, the port on their own 2**-N grid
            assert {k: v for k, v in g.items() if "err" not in k} == \
                {k: v for k, v in w.items() if "err" not in k}
            table = jax_ppoly.fit_gelu_table(-6.4, 6.35, 0.05, scale_bits=bits,
                                             seg=g["seg"], deg=g["deg"],
                                             backend="ibert", optim_bounds=False)
            xs = x_int * 0.05
            from scipy.special import erf
            ref = xs * 0.5 * (1 + erf(xs / np.sqrt(2)))
            assert np.abs(yj * float(table.out_scale) - ref).max() == w["max_err"]
            assert w["max_err"] > 15_000 and g["max_err"] < 0.2
        else:
            assert g == w


def test_ppoly_sweep_ibert_gelu_figures():
    """The figures ROADMAP Queue 3 records: deg 2, seg 16, N 22, scale 0.05,
    ``optim_bounds`` off."""
    row, = ppoly_sweep.sweep("gelu", 0.05, [2], [16], [22], ["ibert"], False, "cpu")
    assert row["max_err"] == pytest.approx(0.10323, abs=1e-5)
    jax_row, = _jax_script("ppoly_sweep").sweep("gelu", 0.05, [2], [16], [22],
                                                ["ibert"], False)
    assert jax_row["max_err"] == pytest.approx(15640.4, abs=0.1)


def test_ppoly_sweep_cli(tmp_path):
    out = tmp_path / "rows.json"
    rows = ppoly_sweep.main(["--function", "softmax", "--degrees", "1", "--segments",
                             "8", "--device", "cpu", "--json", str(out)])
    assert json.loads(out.read_text()) == rows and len(rows) == 1


MINI_YAML_CASES = {
    "indented lists": "grid:\n  a:\n    - 1\n    - x\n  b:\n    - '2'\n",
    "lists at their key's indent": "grid:\n  a:\n  - 1.5\n  b: 3\nname: \"s\"\n",
    "nested mappings": "grid:\n  a:\n    b:\n      - 1\n  c: 0.5\n",
}


@pytest.mark.parametrize("case", sorted(MINI_YAML_CASES))
def test_sweep_mini_yaml_equals_pyyaml(case):
    yaml = pytest.importorskip("yaml")
    text = MINI_YAML_CASES[case]
    assert sweep._mini_yaml(text) == yaml.safe_load(text)


def test_sweep_config_readers_on_sweep_yaml():
    """The port's reader is PyYAML's on ``sweep.yaml``; JAX's nests each
    indented list one level too deep (a reference fault, ROADMAP Queue 3:
    JAX's sweep runs only where PyYAML imports), and with PyYAML both
    scripts load the same config and expand the same points."""
    yaml = pytest.importorskip("yaml")
    jax_sweep = _jax_script("sweep")
    path = os.path.join(ROOT, "sweep.yaml")
    text = open(path).read()
    want = yaml.safe_load(text)
    assert sweep._mini_yaml(text) == want
    assert jax_sweep._mini_yaml(text) == {
        "grid": {k: {k: v} for k, v in want["grid"].items()}}
    assert sweep.load_config(path) == jax_sweep.load_config(path) == want
    assert len(sweep.points(sweep._mini_yaml(text))) == 8
    for s in ("8", "0.5", "'a'", '"8,8"', "ivit"):
        assert sweep._coerce(s) == jax_sweep._coerce(s)


def test_sweep_dry_run_matches_jax(tmp_path, capsys, monkeypatch):
    jax_sweep = _jax_script("sweep")
    monkeypatch.setattr("sys.argv", ["sweep.py", "--config",
                                     os.path.join(ROOT, "sweep.yaml"), "--dry-run",
                                     "--output-dir", str(tmp_path / "jax")])
    jax_sweep.main()
    jax_lines = capsys.readouterr().out.splitlines()
    recs = sweep.main(["--config", os.path.join(ROOT, "sweep.yaml"), "--dry-run",
                       "--output-dir", str(tmp_path / "port"), "--device", "cpu",
                       "--extra", "--epochs", "1"])
    port_lines = capsys.readouterr().out.splitlines()
    assert port_lines[0] == jax_lines[0] == "8 sweep points over ['bitwidth', 'layer-type']"
    jax_cmds = [line.split()[1:] for line in jax_lines if line.startswith("[")]
    assert len(recs) == len(jax_cmds) == 8
    for rec, jcmd in zip(recs, jax_cmds):
        cmd = rec["cmd"]
        assert jcmd[1] == "scripts/quant_train.py"
        assert cmd[1:3] == ["-m", "ivit_tpu_torch.scripts.quant_train"]
        j = jcmd.index("--run-id")
        assert rec["run_id"] == jcmd[j + 1] == cmd[cmd.index("--run-id") + 1]
        k = cmd.index("--run-id")
        assert cmd[k:-4] == jcmd[j:]
        assert cmd[-4:] == ["--device", "cpu", "--epochs", "1"]
        assert cmd[cmd.index("--output-dir") + 1] == str(tmp_path / "port")
    assert [r["run_id"] for r in recs][:2] == ["bitwidth-8_layer-type-ivit",
                                              "bitwidth-8_layer-type-ibert"]


def test_sweep_runs_a_point_on_the_cpu(tmp_path, monkeypatch):
    cfg = tmp_path / "one.yaml"
    cfg.write_text("grid:\n  layer-type:\n    - ivit\n  bitwidth:\n    - 8\n")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(tmp_path)          # the points run from the repository root
    recs = sweep.main(["--config", str(cfg), "--output-dir", "out", "--device", "cpu",
                       "--extra", "--dataset", "synthetic", "--synthetic-samples", "4",
                       "--batch-size", "2", "--img-size", "64", "--epochs", "1",
                       "--calibration-batches", "1"])
    rec, = recs
    assert rec["returncode"] == 0, rec.get("stderr_tail")
    assert rec["final"]["phase"] == "epoch" and rec["final"]["epoch"] == 0
    assert np.isfinite(rec["final"]["loss"])
    with open(tmp_path / "out" / "sweep_summary.jsonl") as f:
        assert [json.loads(line) for line in f] == recs
