"""The tiny stage-3 train step as a full fine-tune (no LoRA, no int8
base) under gradient checkpointing: port vs JAX package over three
steps, with the helpers and tolerances of tests/test_torch_train_step.py
(its own file so the two long JAX compiles run on separate workers)."""

from test_torch_train_step import (
    check_metrics,
    check_params,
    init_params,
    make_batch,
    run_both,
)


def test_full_finetune_with_remat_matches_jax():
    params = init_params(2)
    for i, jm, tm, jp, tp in run_both(
            params, 3, [make_batch(seed=1)], num_train_steps=10,
            warmup_ratio=0.1, gradient_accumulation_steps=1,
            gradient_checkpointing=True):
        check_metrics(jm, tm)
        check_params(jp, tp, max(0, i))
