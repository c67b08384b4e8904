"""Scale-out: the ("dp", "tp") mesh over torch.distributed (`mesh.py`) and
mesh-parallel serving (`serve.py`)."""
