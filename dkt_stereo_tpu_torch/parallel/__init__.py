"""Multi-process execution: process groups, collectives and local ranks
(``parallel/mesh.py``)."""
