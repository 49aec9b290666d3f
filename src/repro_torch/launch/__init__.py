"""Entry points: the training launcher (``train.py``) and the dry-run
(``dryrun.py``) with the meshes, sharding rules and cost model it lays out
(``mesh.py``, ``shardings.py``, ``costmodel.py``)."""
