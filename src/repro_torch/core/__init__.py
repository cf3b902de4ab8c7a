"""Copies of ``repro.core``'s plain-numpy modules the cluster needs
(``topology``, ``ocs``, ``scheduler``, ``costmodel``, ``goodput``,
``autotopo``), with the imports renamed and nothing else changed:
``tests/test_torch_cluster.py`` holds each equal to the reference on the
same inputs."""
