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
    server = lgt.Booster(model_str=bst.model_to_string()).as_server()
    y = server.predict(rows)                     # CUDA traversal

A ranker takes query groups (sizes or per-row query ids) and optional
positions: ``lgt.Dataset(X, label=rel, group=sizes, position=pos)`` with
``{"objective": "lambdarank", "lambdarank_target": "ndcg", "metric":
"ndcg", "eval_at": [10]}`` (or ``rank_xendcg``). A classifier over K
classes takes labels 0..K-1 and ``{"objective": "multiclass", "num_class":
K}`` (or ``multiclassova``), K trees a round, ``multi_logloss`` /
``multi_error`` / ``auc_mu`` as metrics.

Entry points run on the card unless ``device_type="cpu"`` is passed; the
CPU runs every kernel's plain PyTorch version. See README.md ("The PyTorch
port") for what is ported and ROADMAP.md for what is not yet.
"""
from .basic import Booster, Dataset
from .callback import early_stopping, log_evaluation, record_evaluation
from .config import Config
from .engine import train
from .serve import ForestServer

__all__ = ["Booster", "Config", "Dataset", "ForestServer", "early_stopping",
           "log_evaluation", "record_evaluation", "train"]
__version__ = "0.2.0"
