"""The strategy search, on its way from ``flexflow_tpu/search/``.

So far only the program half of ``serialization.py`` is ported: the
layer-list JSON that the torch.fx frontend's ``torch_to_file`` /
``file_to_ff`` write and read. The strategy half (mesh, PartitionSpecs)
comes with the search and the parallel lowering.
"""
from .serialization import program_from_json, program_to_json  # noqa: F401
