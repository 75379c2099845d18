"""Training the enc-dec and VLM stubs (A12.6) and Grok-1's GQA + MoE
(A12.8): 3 float32 steps of the port's ``make_train_step`` against
``repro.train.step.make_train_step`` on reduced SeamlessM4T (with
``frames``: its stacked encoder's scales take weight decay), PaliGemma
(with ``prefix``: the loss leaves the prefix's positions out) and Grok-1,
in ``test_torch_train_families``' band (``lm_parity.
check_three_train_steps``)."""
import pytest

torch = pytest.importorskip("torch")

import lm_parity as P  # noqa: E402


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "paligemma_3b",
                                  "grok_1_314b"])
def test_three_train_steps_match_the_reference(arch):
    P.check_three_train_steps(arch)
