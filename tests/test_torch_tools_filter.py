"""The token filter study of the port (``radzero_torch/tools/token_filter_study.py``)
against the JAX tool's recipe (``tools/token_filter_study.py``) on the CPU,
fp32, at its configuration (D = 64, 4 heads of 16, two layers a tower): from the
JAX weights through the bridge, five training steps on the study's own
sentences, then the held-out logits and maps at ratios 0, 0.25 and 0.5 (the
filter before layer 1) at the suite's compute_logits gate (rtol 1e-3 / atol
2e-4, maps' mean absolute error below 1e-3). The JAX recipe and the weights
are ``test_torch_tools_sanity.py``'s.
"""

import numpy as np

from radzero_torch.models.from_jax import params_from_jax
from radzero_torch.tools import sanity_train as tst
from radzero_torch.tools import token_filter_study as ttf
from tools import token_filter_study as jtf

from test_torch_tools_sanity import BATCH, STEPS, _gate, _jax_run, weights  # noqa: F401


def test_token_filter_table_matches_jax(weights):
    """The study's accuracy_table from the JAX weights at ratios 0, 0.25 and 0.5
    (five steps): the logits and maps at each ratio at the compute_logits gate;
    at ratio 0 the filter is off."""
    ratios = (0.0, 0.25, 0.5)
    _, ref = _jax_run(weights, jtf.make_example, jtf.QUADRANTS, ratios)
    table, outs, _ = ttf.accuracy_table(params_from_jax(weights), tst.sanity_config(4), ratios,
                                     "cpu", steps=STEPS, batch=BATCH)
    assert sorted(table) == [f"ratio_{r}" for r in ratios]
    for ratio in ratios:
        _gate(*outs[ratio], *ref[ratio], f"ratio {ratio}")
        assert set(table[f"ratio_{ratio}"]) == {"retrieval_accuracy", "pointing_accuracy"}
    # dropped patches give zero tower rows, so their map columns differ from ratio 0's
    assert not np.array_equal(outs[0.5][1], outs[0.0][1])
