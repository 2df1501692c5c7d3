"""The dense-slab kNN kernel of the kNN selection bench (``csrc/knn_slab.cu``),
its wrapper (``ops.py``) and its plain version (``ref.py``)."""
