"""Shared fixtures of the benchmark's tests: a tiny copy of the benchmark's
files, made once per test run."""
import pytest

from benchmark.tests import tiny


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("bench")))
