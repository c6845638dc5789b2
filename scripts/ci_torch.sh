#!/usr/bin/env bash
# CI entry point of the PyTorch port (src/repro_torch): the tier-1 tests,
# then a smoke subset of the port's parity tests (each plain version held
# against the JAX package on the CPU), stage by stage as scripts/ci.sh
# runs its interpret-mode subset, then every examples/torch_*.py on the CPU.
#
#   scripts/ci_torch.sh          # full tier-1 + smoke
#   scripts/ci_torch.sh --smoke  # smoke subset only (fast signal)
#
# The CUDA kernels run only on a card: there, `python -m pytest -m cuda
# tests/test_torch_cuda_*.py` and `python3 chip_smoke.py` (README).
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"

if [[ "${1:-}" != "--smoke" ]]; then
  # tier-1: the full suite (ROADMAP.md contract)
  python -m pytest -x -q
fi

# dataflow + backward: OS, WS and hybrid against the reference's XLA
# dataflows, forward and gradients (the transposed-map backward, dW's
# chunked row dot), and the self-transpose shortcut bitwise
python -m pytest -x -q \
  "tests/test_torch_dataflow.py::test_output_stationary_matches_xla" \
  tests/test_torch_dataflow.py::test_cuda_backend_on_cpu_raises_everywhere \
  "tests/test_torch_ws.py::test_weight_stationary_matches_xla" \
  "tests/test_torch_ws.py::test_hybrid_matches_xla" \
  "tests/test_torch_grad.py::test_grads_match_jax" \
  "tests/test_torch_grad.py::test_self_transpose_is_bitwise" \
  "tests/test_torch_grad.py::test_chunked_rowdot_matches_jax_and_is_zero_extension_invariant"

# indexing + repair: the superwindow and window searches' plain versions
# against the Pallas kernels in interpret mode (int32 and int64 words),
# the overflow repair against the reference's, MinkUNet-42's plan maps
python -m pytest -x -q \
  "tests/test_torch_plan.py::test_superwindow_plain_matches_pallas_interpret" \
  "tests/test_torch_plan.py::test_plain_matches_pallas_interpret_int64" \
  tests/test_torch_plan.py::test_overflow_cells_are_repaired \
  "tests/test_torch_graphs.py::test_repair_plain_matches_reference" \
  tests/test_torch_core.py::test_zdelta_search_matches

# segment sum: bitwise the reference's XLA and Pallas-interpret sums, the
# chunk tables against enumeration, per-scene BN
python -m pytest -x -q \
  "tests/test_torch_segsum.py::test_segment_sum_bitwise_equals_xla" \
  "tests/test_torch_segsum.py::test_segment_sum_bitwise_equals_pallas_interpret" \
  tests/test_torch_segsum.py::test_segment_sum_alignment_and_zero_extension_invariant \
  "tests/test_torch_segsum.py::test_relu_bn_matches"

# session: batched bit-identity on both search engines + the bucket count
python -m pytest -x -q \
  "tests/test_torch_session.py::test_batch_equals_single_runs_bitwise" \
  tests/test_torch_session.py::test_compile_count_is_bucket_count

# serving faults + overload: poison quarantine bitwise, capped retries,
# escalation bitwise, the scheduler, admission, breaker and ladder, the 2x
# overload run bitwise; then the three serving examples
python -m pytest -x -q \
  "tests/test_torch_serve_faults.py::test_poison_isolated_bitwise" \
  tests/test_torch_serve_faults.py::test_transient_fault_retried_with_capped_backoff \
  tests/test_torch_serve_faults.py::test_overflow_escalation_matches_lossless_bitwise \
  tests/test_torch_serve_overload.py::test_dead_on_arrival_expires_at_submit \
  tests/test_torch_serve_overload.py::test_bucket_scheduler_edf_and_excision \
  tests/test_torch_serve_overload.py::test_admission_controller_law \
  tests/test_torch_serve_overload.py::test_breaker_trips_fails_fast_and_recovers \
  tests/test_torch_serve_overload.py::test_ladder_walks_up_and_down_with_hysteresis \
  "tests/test_torch_serve_overload.py::test_two_x_overload_bounded_and_bitwise"

# training robustness: a NaN batch a bitwise no-op, the poisoned run
# bitwise the clean run on the healthy work, resume past a corrupt
# checkpoint, rollback, the manager's fallback, orphans and async failures
python -m pytest -x -q \
  "tests/test_torch_train_guard.py::test_nonfinite_batch_is_bitwise_noop" \
  tests/test_torch_train_guard.py::test_poisoned_run_bitwise_equals_clean_run_on_healthy_work \
  tests/test_torch_train_guard.py::test_resume_walks_past_corrupt_latest \
  tests/test_torch_train_guard.py::test_rollback_restores_last_good \
  tests/test_torch_ckpt.py::test_fallback_walks_to_newest_verifying \
  tests/test_torch_ckpt.py::test_preempted_save_leaves_rejectable_orphan \
  tests/test_torch_ckpt.py::test_async_write_failure_reraised_on_next_save

# obs: the pinned FakeClock snapshot, the zero-overhead invariant, the
# exported gauges and counters, the checkpoint manager's spans and bytes
python -m pytest -x -q \
  tests/test_torch_serve_engine.py::test_fake_clock_serve_snapshot_is_exactly_pinned \
  tests/test_torch_serve_engine.py::test_zero_overhead_invariant \
  tests/test_torch_serve_engine.py::test_breaker_gauge_and_outcome_counters_exported \
  tests/test_torch_ckpt.py::test_manager_records_spans_and_bytes

# every example of the port, headless on the CPU (each asserts in-process:
# bitwise batched == single, loss decrease, bit-exact checkpoints, the
# self-healing run, the serving engines' outcomes and metrics export)
for ex in torch_quickstart torch_pointcloud_inference torch_train_pointcloud \
          torch_robust_train torch_serve_lm torch_pointcloud_serve \
          torch_robust_serve torch_overload_serve; do
  python "examples/$ex.py" --smoke --device cpu >/dev/null
done
lm_ckpt="$(mktemp -d)"
python examples/torch_train_lm.py --smoke --device cpu --steps 3 \
  --ckpt-dir "$lm_ckpt" >/dev/null
rm -rf "$lm_ckpt"

# scripts/ci.sh's four benchmark lines (bench_serve, bench_train, the
# dataflow run and bench_e2e) have no counterpart yet: the port's
# benchmark PR adds them.
echo "ci_torch.sh: OK"
