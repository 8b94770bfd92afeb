"""Fixtures of the benchmark's CPU tests."""
from __future__ import annotations

import pytest

from bench_cells import free_port, small_cell


@pytest.fixture
def port():
    return free_port()


@pytest.fixture
def small():
    """:func:`bench_cells.small_cell`."""
    return small_cell
