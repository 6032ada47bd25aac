"""The golden-number harness of the port (cli/reproduce_baseline.py
--smoke) on the CPU: each config's evaluation loop runs end to end through
the port's CLIs on synthetic fixtures, with random weights, and prints a
well-formed verdict. The configs are those of the JAX package's own test
(tests/test_reproduce_baseline.py); the harness's table is JAX's."""

import json
import sys

import pytest
import torch

from unilm_tpu.cli import reproduce_baseline as jrb
from unilm_tpu_torch.cli import reproduce_baseline as trb

torch.set_num_threads(2)


def test_golden_table_is_jax():
    assert trb.GOLDEN == jrb.GOLDEN


@pytest.mark.parametrize("config", ["trocr_iam", "funsd", "kosmos_ocr",
                                    "beit_base_eval"])
def test_smoke(config, capsys, monkeypatch):
    # kosmos_infer decodes with tiktoken only from its cache; hidden here
    monkeypatch.setitem(sys.modules, "tiktoken", None)
    v = trb.main(["--config", config, "--smoke", "--device", "cpu"])
    assert v["config"] == config and v["smoke"] is True
    assert isinstance(v["measured"], float)
    assert v["golden"] == trb.GOLDEN[config]["value"]
    assert v["metric"] == trb.GOLDEN[config]["metric"]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == v


def test_device_defaults_to_the_card():
    """Without --device the loops run on the card: a host without one
    raises, naming --device cpu."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'|--device cpu"):
        trb.main(["--config", "trocr_iam", "--smoke"])
