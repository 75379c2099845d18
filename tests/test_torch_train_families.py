"""Training the block kinds of A12.3–A12.5 (A12.8): the port's
``make_train_step`` against ``repro.train.step.make_train_step``.

* ``decays`` against the reference's rule (``p.ndim >= 2`` on the leaf as
  the reference stacks it: periods and the encoder carry one more leading
  dimension) for every parameter of all ten reduced configs; SeamlessM4T's
  encoder scales decay (the port's once did not: this test fails there).
* 3 float32 steps of reduced DeepSeek-V2-Lite (MLA + MoE), Mamba2 (SSD)
  and RecurrentGemma (RG-LRU + ring attention) from the reference's
  weights and optimizer state after 2 of its steps, as ``test_torch_train``
  holds the dense configs (``lm_parity.check_three_train_steps``): loss
  and grad norm within 1e-5 relative at every step, every parameter within
  atol 1e-6 but at most 4 elements within 1e-3 (an element whose gradient
  is cancellation noise at Adam's eps takes most of a step either way),
  each tensor's gap within 1e-2 of its update in the L2 norm, the moments
  within atol 1e-7: the dense configs' float32 band, which every family
  meets.
  The stub families (SeamlessM4T, PaliGemma) and Grok-1:
  ``test_torch_train_stubs``.
"""
import jax
import pytest

torch = pytest.importorskip("torch")

import lm_parity as P  # noqa: E402
import repro.configs as ref_configs  # noqa: E402
from repro.lm import model as ref_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.lm import model  # noqa: E402
from repro_torch.train import step  # noqa: E402


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_decays_follows_the_references_stacked_leaf_ranks(arch):
    rcfg = ref_configs.reduced(ref_configs.get_config(arch))
    cfg = configs.reduced(configs.get_config(arch))
    shapes = jax.eval_shape(
        lambda: ref_model.init_params(rcfg, jax.random.PRNGKey(0)))
    m = model.LM(cfg, device="meta")
    params = dict(m.named_parameters())
    pairs = P.port_leaf_names(shapes, rcfg)
    assert sorted(n for n, _, _ in pairs) == sorted(params)
    for name, leaf, _ in pairs:
        assert step.decays(cfg, name, params[name]) == (leaf.ndim >= 2), name
    if cfg.n_enc_layers:
        assert step.decays(cfg, "encoder.1.norm1.scale",
                           params["encoder.1.norm1.scale"])


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "mamba2_780m",
                                  "recurrentgemma_9b"])
def test_three_train_steps_match_the_reference(arch):
    P.check_three_train_steps(arch)
