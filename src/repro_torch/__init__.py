"""PyTorch / CUDA port of the mpEDM causal-inference reproduction.

Sits beside the JAX package ``repro`` (the reference it is tested
against) and mirrors its layout: ``core/`` (embedding, statistics, kNN
tables, phase 1 simplex, phase 2 CCM, the pipeline), ``engine/`` (the
``torch-reference`` and ``cuda`` engines), ``kernels/<name>/`` (CUDA C++
for ``sm_90a`` with a plain PyTorch version beside each kernel),
``data/`` and ``runtime/`` (the store, the chunk streamer, integrity),
and ``launch/`` (the ``edm_run`` CLI).  It imports ``torch`` and
``numpy`` only; design notes are in ``docs/PORT.md``.
"""
