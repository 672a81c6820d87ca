"""lambdagap_tpu_torch — the PyTorch/CUDA port of lambdagap_tpu.

A package of its own beside the JAX package (which stays the reference):
it imports ``torch`` and ``numpy`` and nothing of ``lambdagap_tpu``. It
trains a forest with any objective of the JAX package on the card and
serves it::

    import lambdagap_tpu_torch as lgt
    train = lgt.Dataset(X, label=y)
    valid = lgt.Dataset(Xv, label=yv, reference=train)
    bst = lgt.train({"objective": "binary", "metric": ["auc"]}, train,
                    100, valid_sets=[valid],
                    callbacks=[lgt.early_stopping(10)])  # CUDA histograms
    more = lgt.train(params, train, 20, init_model=bst)  # continued
    res = lgt.cv(params, lgt.Dataset(X, label=y, free_raw_data=False), 50)
    server = lgt.Booster(model_str=bst.model_to_string()).as_server()
    y = server.predict(rows)                     # CUDA traversal
    server.add_model("b", "model_b.txt")         # a multi-model registry
    server.swap("model_v2.txt")                  # hot swap, a new generation

A ranker takes query groups (sizes or per-row query ids) and optional
positions: ``lgt.Dataset(X, label=rel, group=sizes, position=pos)`` with
``{"objective": "lambdarank", "lambdarank_target": "ndcg", "metric":
"ndcg", "eval_at": [10]}`` (or ``rank_xendcg``). A classifier over K
classes takes labels 0..K-1 and ``{"objective": "multiclass", "num_class":
K}`` (or ``multiclassova``), K trees a round, ``multi_logloss`` /
``multi_error`` / ``auc_mu`` as metrics.

A Booster also answers ``predict(..., pred_leaf=True)`` (the traversal
kernel's carry under the default ``compiled`` engine) and
``predict(..., pred_contrib=True)`` (TreeSHAP on a CUDA kernel), refits,
rolls back, dumps its JSON and pickles; it trains on custom gradients
(``update(fobj=)``, ``objective=none``), takes ``reset_parameter`` and
``feval``, and boosts as ``gbdt``, ``dart`` or ``rf``. ``predict_engine``
is ``compiled``, ``tensor`` or ``scan``, all bit-identical. ``LGBMRegressor`` /
``LGBMClassifier`` / ``LGBMRanker`` wrap ``train`` for scikit-learn users.

Out of core, the binned matrix stays in host row shards and the learners
stream windows of it to the card::

    sds = lgt.ShardedBinnedDataset.from_matrix(X, lgt.Config.from_params(
        {}), shard_rows=1 << 20, label=y)     # or from_sequences([...])
    bst = lgt.train(params, lgt.Dataset(sds), 100)   # data_residency=auto
    scores = bst.predict_stream(Xv_memmap, out=out_memmap)

Entry points run on the card unless ``device_type="cpu"`` is passed; the
CPU runs every kernel's plain PyTorch version. See README.md ("The PyTorch
port") for what is ported and ROADMAP.md for what is not yet.
"""
from .basic import Booster, Dataset, Sequence
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .data.dataset import BinnedDataset, Metadata
from .data.stream import ShardedBinnedDataset
from .engine import CVBooster, cv, train
from .models.gbdt import GBDT
from .models.tree import Tree
from .serve import ForestServer, ServeResult
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
from .utils.log import register_logger

__all__ = ["BinnedDataset", "Booster", "CVBooster", "Config", "Dataset",
           "EarlyStopException", "ForestServer", "GBDT", "LGBMClassifier",
           "LGBMModel", "LGBMRanker", "LGBMRegressor", "Metadata",
           "Sequence", "ServeResult", "ShardedBinnedDataset", "Tree", "cv",
           "early_stopping", "log_evaluation", "record_evaluation",
           "register_logger", "reset_parameter", "train"]
__version__ = "0.2.0"

# names the JAX package exports from layers the port does not carry yet:
# asking for one raises, naming it, instead of an AttributeError
_UNPORTED = {
    "train_cluster": "multi-process training (ROADMAP.md, Queue 1 item 8)",
    "plot_importance": "plotting (ROADMAP.md, Queue 1 item 7)",
    "plot_metric": "plotting (ROADMAP.md, Queue 1 item 7)",
    "plot_split_value_histogram": "plotting (ROADMAP.md, Queue 1 item 7)",
    "plot_tree": "plotting (ROADMAP.md, Queue 1 item 7)",
    "create_tree_digraph": "plotting (ROADMAP.md, Queue 1 item 7)",
}


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"{name} is not ported to lambdagap_tpu_torch yet: "
            f"{_UNPORTED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
