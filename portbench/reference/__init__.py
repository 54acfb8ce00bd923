"""The plain reference the benchmark holds the program against (``model.py``).

It imports nothing of the program: ``test_portbench_isolation.py`` checks."""
