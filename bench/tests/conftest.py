"""The benchmark's own tests: a tiny copy of the benchmark, made once a session."""

import pytest

from bench.tests.tiny import make_tiny_copy


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_copy(tmp_path_factory.mktemp("tiny"))
