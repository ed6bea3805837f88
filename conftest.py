"""Pytest hooks shared by the repository's test directories.

proofbench/tests/test_pbench_reference.py's `tiny_bench` fixture gives each
configuration of BENCHMARK.json a CPU size from that module's TINY table,
and raises KeyError on a configuration the table lacks. sha256_2e20 runs in
none of the fixture's cells, so its file is copied as it is: the entry is
empty. It is given here, after collection, so that the module runs alone
as well as beside the others. Once the fixture passes over configurations
it has no size for, this file goes.
"""

TINY_EXTRA = {"sha256_2e20": {}}


def pytest_collection_modifyitems(session, config, items):
    for item in items:
        module = getattr(item, "module", None)
        if getattr(module, "__name__", "") == "test_pbench_reference":
            for name, size in TINY_EXTRA.items():
                module.TINY.setdefault(name, size)
