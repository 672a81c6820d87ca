"""The PyTorch port stands alone and never falls back to the CPU.

``lambdagap_tpu_torch``, ``chip_smoke.py`` and the A/B scripts
(``dispatch_ab.py``, ``train_ab.py``) import neither ``jax`` nor
``lambdagap_tpu``: a subprocess with both blocked in ``sys.modules`` loads
a JAX-saved model, predicts and serves on the CPU (the registry, a swap
and a delta frame included), then trains quantized and bagged over EFB
bundles (the threefry draws, the samplers, the int8 histograms and the
bundling included), and trains and scores out of core (a streamed
``ShardedBinnedDataset``, ``predict_stream``), then trains DART under a
``reset_parameter`` schedule, continues it with ``init_model`` and
cross-validates (``cv``), then trains, serves and explains linear leaves
(``ops/linear.py``, ``models/linear_leaf.py``). Asking for the card where
there is none raises instead of quietly running on the CPU.
"""
import torch_cpu_threads  # noqa: F401  (first: one torch thread)
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lambdagap_tpu as lgb
import lambdagap_tpu_torch as lgt

REPO = Path(__file__).resolve().parents[1]

_CHILD = r"""
import sys
sys.modules["jax"] = None            # any import of jax now raises
sys.modules["lambdagap_tpu"] = None
sys.path.insert(0, {repo!r})
import numpy as np
import lambdagap_tpu_torch as lgt
text = open({model!r}).read()
X = np.load({rows!r})
bst = lgt.Booster(model_str=text, params={{"device_type": "cpu"}})
raw = bst.predict(X, raw_score=True)
from lambdagap_tpu_torch.serve import delta, registry, swap
with bst.as_server(raw_score=True) as server:
    served = server.predict(X)
    base = server.model_text()
    server.add_model("m2", base)
    assert swap.load_booster(base, {{"device_type": "cpu"}}).device.type == "cpu"
    assert server.swap(base, model="m2") == 1
    assert delta.make_delta(base, base)["append"] == ""
    assert isinstance(server.registry, registry.ModelRegistry)
assert np.array_equal(raw, served)
np.save({out!r}, raw)
rng = np.random.RandomState(1)
onehot = np.eye(4)[rng.randint(0, 4, 400)] * rng.randint(1, 5, (400, 1))
Xt = np.concatenate([rng.randn(400, 3), onehot], axis=1)
yt = (Xt[:, 0] + Xt[:, 3] > 0.5).astype(float)
trained = lgt.train({{"device_type": "cpu", "objective": "binary",
                     "verbose": -1, "num_leaves": 7, "min_data_in_leaf": 5,
                     "use_quantized_grad": True, "bagging_fraction": 0.8,
                     "bagging_freq": 1}}, lgt.Dataset(Xt, label=yt), 3)
assert trained._booster.learner.bundle is not None
assert np.isfinite(trained.predict(Xt)).all()
cfg = lgt.Config.from_params({{"device_type": "cpu"}})
sds = lgt.ShardedBinnedDataset.from_matrix(Xt, cfg, shard_rows=1024,
                                           label=yt)
streamed = lgt.train({{"device_type": "cpu", "objective": "binary",
                      "verbose": -1, "num_leaves": 7,
                      "bagging_fraction": 0.8, "bagging_freq": 1}},
                     lgt.Dataset(sds), 3)
assert streamed._booster.learner.residency == "stream"
st = {{}}
scores = streamed.predict_stream(Xt, window_rows=128, stats_out=st)
assert np.array_equal(scores, streamed.predict(Xt)) and st["windows"] == 4
from lambdagap_tpu_torch.models import dart
api = {{"device_type": "cpu", "objective": "binary", "verbose": -1,
       "num_leaves": 7}}
dart_bst = lgt.train({{**api, "boosting": "dart", "drop_rate": 0.5,
                      "skip_drop": 0.0}}, lgt.Dataset(Xt, label=yt), 3,
                     callbacks=[lgt.reset_parameter(learning_rate=[0.1, 0.2,
                                                                   0.1])])
assert isinstance(dart_bst._booster, dart.DART)
more = lgt.train(api, lgt.Dataset(Xt, label=yt), 1, init_model=dart_bst)
assert more.num_trees() == 4
res = lgt.cv(api, lgt.Dataset(Xt, label=yt, free_raw_data=False), 2,
             nfold=2, return_cvbooster=True)
assert isinstance(res["cvbooster"], lgt.CVBooster)
from lambdagap_tpu_torch.ops import linear as linear_ops
from lambdagap_tpu_torch.models import linear_leaf
assert linear_ops.leaf_feature_width(7, 7) == 8
lin = lgt.train({{"device_type": "cpu", "objective": "regression",
                 "verbose": -1, "num_leaves": 7, "linear_tree": True}},
                lgt.Dataset(Xt, label=Xt[:, 0] + 2 * Xt[:, 1]), 3)
assert all(t.is_linear for t in lin._booster.host_models)
lin_raw = lin.predict(Xt, raw_score=True)
with lin.as_server(raw_score=True) as server:
    assert np.array_equal(server.predict(Xt), lin_raw)
phi = lin.predict(Xt, pred_contrib=True)
assert np.allclose(phi.sum(1), lin_raw, rtol=1e-5, atol=1e-6)
bad = sorted(m for m in sys.modules
             if (m == "jax" or m.startswith("jax.")
                 or m == "lambdagap_tpu" or m.startswith("lambdagap_tpu."))
             and sys.modules[m] is not None)
assert not bad, bad
print("ISOLATED_OK")
"""


def _model():
    rng = np.random.RandomState(0)
    X = rng.randn(600, 6).astype(np.float32)
    X[::7, 2] = np.nan
    y = (X[:, 0] - X[:, 1] > 0).astype(np.float32)
    b = lgb.train({"verbose": -1, "objective": "binary", "num_leaves": 7,
                   "tpu_fast_predict_rows": 0, "predict_engine": "compiled"},
                  lgb.Dataset(X, label=y), num_boost_round=5)
    return b, X


def test_port_runs_with_jax_and_reference_blocked(tmp_path):
    b, X = _model()
    model = tmp_path / "m.txt"
    model.write_text(b.model_to_string())
    rows, out = tmp_path / "x.npy", tmp_path / "raw.npy"
    np.save(rows, X)
    code = _CHILD.format(repo=str(REPO), model=str(model), rows=str(rows),
                         out=str(out))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED_OK" in proc.stdout
    assert np.array_equal(np.load(out), b.predict(X, raw_score=True))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix()
     for p in (REPO / "lambdagap_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py", "dispatch_ab.py", "train_ab.py"]))
def test_no_source_imports_jax_or_the_jax_package(path):
    for name in _imports(REPO / path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "lambdagap_tpu"), (path, name)


def test_cuda_default_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default runs on it")
    b, _X = _model()
    with pytest.raises(RuntimeError, match="device_type=cpu"):
        lgt.Booster(model_str=b.model_to_string(), params={})
    with pytest.raises(RuntimeError, match="device_type=cpu"):
        lgt.Booster(model_str=b.model_to_string())


def test_stream_kernels_and_rings_never_fall_back_to_the_cpu():
    """K1's accumulate mode and the rings on a non-CPU, non-CUDA tensor or
    device raise: no path quietly takes the plain version."""
    from lambdagap_tpu_torch.data.stream import ShardRing
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    meta = torch.device("meta")
    bins = torch.zeros((8, 3), dtype=torch.uint8, device=meta)
    g = torch.zeros(8, device=meta)
    scale = torch.zeros(2, dtype=torch.int32, device=meta)
    acc = hc.hist_acc(3, 4, meta)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        hc.hist_rows_add(acc, bins, g, g, None, 8, 4, scale)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        hc.hist_finish(acc, scale)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ShardRing(meta, 2)


def test_cuda_tensor_never_reaches_the_plain_traversal():
    """A tensor on any non-CPU device goes to the kernel or raises: the
    wrapper has no fallback to the plain version."""
    from lambdagap_tpu_torch.infer import compile_forest
    from lambdagap_tpu_torch.infer import engine as eng
    b, X = _model()
    port = lgt.Booster(model_str=b.model_to_string(),
                       params={"device_type": "cpu"})
    tables = eng.device_tables(compile_forest(port._booster),
                               torch.device("cpu"))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        eng.traverse_forest(torch.from_numpy(X).to("meta"), tables)


def test_linear_mode_never_falls_back_to_the_plain_version():
    """The fused kernel's linear mode on a non-CPU, non-CUDA tensor raises
    too: no linear path quietly takes the plain version."""
    from lambdagap_tpu_torch.infer import compile_forest
    from lambdagap_tpu_torch.infer import engine as eng
    from lambdagap_tpu_torch.models import synth
    from lambdagap_tpu_torch.convert import booster_from_numpy
    trees = synth.linearize(synth.random_trees(1, 3, 7, 4, grid_size=8), 2)
    port = booster_from_numpy(synth.header(4), trees,
                              {"device_type": "cpu"})
    cf = eng.CompiledForest(compile_forest(port._booster),
                            torch.device("cpu"))
    assert cf.linear is not None
    x = torch.zeros((3, 4), device="meta")
    t = cf.tables
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        eng.predict_forest(x, t, t.group_tree_lo, t.group_tree,
                           cf._leaf_value, cf._tree_class, 1, 0, 0.0,
                           linear=cf.linear)


@pytest.mark.parametrize("params, exc, match", [
    ({"predict_engine": "bogus", "device_type": "cpu"},
     RuntimeError, "unknown predict_engine"),
    ({"device_type": "tpu"}, RuntimeError, "device_type must be one of"),
])
def test_config_refuses_what_the_port_does_not_run(params, exc, match):
    with pytest.raises(exc, match=match):
        lgt.Config.from_params(params)


def test_port_defaults_differ_in_exactly_two_places():
    from lambdagap_tpu.config import Config as JaxConfig
    port, ref = lgt.Config().to_dict(), JaxConfig().to_dict()
    assert sorted(port) == sorted(ref)
    diff = {k for k in ref if port[k] != ref[k]}
    assert diff == {"device_type", "predict_engine"}
    assert port["device_type"] == "cuda"
    assert port["predict_engine"] == "compiled"
