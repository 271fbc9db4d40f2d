"""Data parallelism of the port: the process group and the collectives of
a data-parallel step (``mesh.py``), and the processes of a one-host run
(``launch.py``)."""
