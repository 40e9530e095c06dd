"""Fixtures of the benchmark's CPU tests."""

import pytest

from benchmark.tests._util import tiny_root


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """A copy of the benchmark at the CPU's size (``_util.TINY``)."""
    return tiny_root(tmp_path_factory.mktemp("tiny"))
