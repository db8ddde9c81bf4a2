"""Repository-wide test isolation.

The JAX package's CLI installs its device mesh for the whole process and
never takes it down, so a test that runs ``cli.main`` would hand its mesh
to every later test of the same worker.  The fixture below clears it
after each test.  Only ``sys`` and ``pytest`` are imported here, so that
``tests/conftest.py`` still configures JAX before anything imports it.
"""
import sys

import pytest


@pytest.fixture(autouse=True)
def _reset_reference_mesh():
    yield
    mesh = sys.modules.get("falcon_genome_tpu.parallel.mesh")
    if mesh is not None:
        mesh.set_active_mesh(None)
