"""kubetpu_torch: the PyTorch/CUDA port of ``kubetpu``'s model path (serving
and single-card training).

The package mirrors ``kubetpu``'s layout (``kubetpu/jobs/x.py`` ->
``kubetpu_torch/jobs/x.py``, ``kubetpu/ops/x.py`` ->
``kubetpu_torch/ops/x.py``) and runs on an NVIDIA Hopper card. It imports
``torch`` and ``numpy`` only: nothing of JAX and nothing of ``kubetpu``.

Entry points (model construction, the servers, the train state and steps)
run on the card by default. Without CUDA they raise unless the caller
passes ``device="cpu"``, which the tests do; on the CPU every hand-written
kernel's wrapper takes its plain PyTorch version.
"""
