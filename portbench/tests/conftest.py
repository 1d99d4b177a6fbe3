import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark's tree with the tiny CPU cells added."""
    from portbench.tests.tiny import tiny_root

    return tiny_root(tmp_path_factory.mktemp("portbench"))
