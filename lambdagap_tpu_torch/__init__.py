"""lambdagap_tpu_torch — the PyTorch/CUDA port of lambdagap_tpu.

A package of its own beside the JAX package (which stays the reference):
it imports ``torch`` and ``numpy`` and nothing of ``lambdagap_tpu``. This
slice serves a LightGBM v4 text model on the card::

    import lambdagap_tpu_torch as lgt
    bst = lgt.Booster(model_file="model.txt")   # device_type="cuda" default
    server = bst.as_server()                     # compiled engine, CUDA kernel
    y = server.predict(rows)

Entry points run on the card unless ``device_type="cpu"`` is passed; the
CPU runs every kernel's plain PyTorch version. See README.md ("The PyTorch
port") for what is ported and ROADMAP.md for what is not yet.
"""
from .basic import Booster
from .config import Config
from .serve import ForestServer

__all__ = ["Booster", "Config", "ForestServer"]
__version__ = "0.1.0"
