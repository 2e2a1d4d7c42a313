import dataclasses
import os
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

TOY_VOCAB = 256


@pytest.fixture
def toy_arch(monkeypatch):
    """``get_config`` gives each arch's tiny preset with its vocabulary
    cut to ``TOY_VOCAB`` ids: the model that
    ``serve_fixture/model_config.json`` describes."""
    from repro_torch import configs
    full = configs.get_config

    def toy(name):
        return dataclasses.replace(full(name).tiny(), vocab=TOY_VOCAB)

    monkeypatch.setattr(configs, "get_config", toy)
