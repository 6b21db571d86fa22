"""The prefill-spread tool's bookkeeping on the CPU: every linear, norm and
attention call of the three prefills is recorded in order, and the first
call whose inputs agree and outputs differ is the one named."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.tools import prefill_spread as ps


def test_ranges_compress_row_counts():
    assert ps._ranges([True, True, False, True]) == \
        [[1, 2, True], [3, 3, False], [4, 4, True]]
    assert ps._ranges([]) == []


@pytest.mark.parametrize("n,bucket", [(5, 64), (64, 64), (65, 128)])
def test_bucket_is_the_pow2_ladder_from_64(n, bucket):
    assert ps._bucket(n) == bucket


def test_first_split_names_the_call_whose_inputs_agree():
    cfg = llama_tiny_config()
    model = LlamaForCausalLM(cfg, device="cpu")
    p = np.random.RandomState(0).randint(0, cfg.vocab_size, 21)
    with torch.no_grad():
        runs = ps._record(model, p.astype(np.int64))
        # per layer: two norms, q/k/v/o, attention, gate/up/down; then the
        # final norm and the head
        assert [len(r) for r in runs.values()] == \
            [10 * cfg.num_hidden_layers + 2] * 3
        assert runs["b1"][4][0] == "attention"
        same = ps._first_splits({"a": runs["b1"], "b": runs["b1"]}, "a", "b")
        assert same["first_output_diff"] is None
        assert same["same_inputs_other_outputs"] == []
        # one call's output changed with its inputs kept: that call alone
        # is named
        name, ins, out = runs["b1"][3]
        other = list(runs["b1"])
        other[3] = (name, ins, out + 1.0)
        split = ps._first_splits({"a": runs["b1"], "b": other}, "a", "b")
        assert split["first_output_diff"] == [3, name]
        assert [c["call"] for c in split["same_inputs_other_outputs"]] == [3]
