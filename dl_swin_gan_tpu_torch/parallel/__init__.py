"""Multi-GPU: the data x fsdp x model mesh (`parallel/mesh.py`) and the
launcher that runs a function on the ranks of one process group
(`parallel/launch.py`)."""
