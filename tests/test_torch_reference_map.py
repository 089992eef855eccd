"""Every test function of the JAX package's own test files, mapped to the
port test that covers it, or to the reason it has none; and the port's
rule that it never imports JAX or the JAX package, checked in a process
where both are blocked.

A mapping is "test_torch_<file>.py::<name>" (a test function of that file),
or "jax-only: <reason>", the reason one of REASONS; a jax-only entry may
name the port tests that hold the same behavior ("; see <file>::<name>,
..."). The test fails when a JAX test function has no entry, when an entry
names a port test that does not exist, or when a reason is not on the
list."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent

REASONS = (
    "Pallas interpret mode",       # the TPU kernels run interpreted; the port's twin and kernel tests instead
    "JAX jit/HLO internals",       # what XLA traced or compiled, which the port has no counterpart of
    "benchmark/ is not ported",    # the harness, BBOB, COCO and parity folder, not ported in this round
    "the reference implementation's goldens",  # needs a checkout of the reference beside the repo
)

PALLAS_MATERN = ("jax-only: Pallas interpret mode; see test_torch_hopper_kernels.py::"
                 "test_matern_plain_matches_pallas_and_xla, test_torch_cuda_kernels.py::"
                 "test_matern_kernel_matches_twin")
BENCHMARK = "jax-only: benchmark/ is not ported"
GOLDENS = "jax-only: the reference implementation's goldens"

REFERENCE_MAP = {
    # tests/test_acquisition.py
    "test_acquisition.py::test_ei_golden": "test_torch_acquisition.py::test_ei_golden",
    "test_acquisition.py::test_ei_zero_sd_is_zero": "test_torch_acquisition.py::test_ei_zero_sd_is_zero",
    "test_acquisition.py::test_pi_golden": "test_torch_acquisition.py::test_pi_golden",
    "test_acquisition.py::test_ucb_is_linear": "test_torch_acquisition.py::test_ucb_is_linear",
    "test_acquisition.py::test_mgfi_golden_and_clamp": "test_torch_acquisition.py::test_mgfi_golden_and_clamp",
    "test_acquisition.py::test_batch_shapes": "test_torch_acquisition.py::test_batch_shapes",
    "test_acquisition.py::test_gei_matches_mc_and_reduces_to_ei": "test_torch_acquisition.py::test_gei_matches_mc",
    "test_acquisition.py::test_gei_in_bo_loop": "test_torch_acquisition.py::test_gei_through_bo",
    # tests/test_api_surface.py
    "test_api_surface.py::test_reference_all_importable": "test_torch_api_surface.py::test_reference_all_importable",
    "test_api_surface.py::test_all_list_consistent": "test_torch_api_surface.py::test_all_list_consistent",
    "test_api_surface.py::test_trend_module_contents": "test_torch_api_surface.py::test_trend_module_contents",
    "test_api_surface.py::test_acquisition_classes_constructible":
        "test_torch_api_surface.py::test_acquisition_classes_constructible",
    "test_api_surface.py::test_optim_exports": "test_torch_api_surface.py::test_optim_exports",
    # tests/test_bbob.py
    "test_bbob.py::test_optimum_is_zero_regret": BENCHMARK,
    "test_bbob.py::test_batched_matches_single": BENCHMARK,
    "test_bbob.py::test_instances_differ": BENCHMARK,
    "test_bbob.py::test_regret_trace_triggers": BENCHMARK,
    "test_bbob.py::test_logged_function_counts": BENCHMARK,
    "test_bbob.py::test_run_bo_on_sphere_beats_random": BENCHMARK,
    "test_bbob.py::test_noisy_suite_complete": BENCHMARK,
    "test_bbob.py::test_noisy_zero_at_optimum_and_noisy_elsewhere": BENCHMARK,
    "test_bbob.py::test_noisy_instantiate_dispatch": BENCHMARK,
    # tests/test_bo.py
    "test_bo.py::test_fmin_returns_and_improves": "test_torch_fmin.py::test_fmin_sphere_beats_doe_in_both_packages",
    "test_bo.py::test_fmin_warm_start_x0_y0": "test_torch_bo_api.py::test_fmin_warm_start_x0_y0",
    "test_bo.py::test_bo_continuous_run": "test_torch_bo_api.py::test_bo_continuous_run",
    "test_bo.py::test_bo_ask_tell_manual": "test_torch_bo_api.py::test_bo_ask_tell_manual",
    "test_bo.py::test_bo_fixed_variable_ask": "test_torch_bo_api.py::test_bo_fixed_variable_ask",
    "test_bo.py::test_bo_flat_fitness_error": "test_torch_bo_api.py::test_bo_flat_fitness_error",
    "test_bo.py::test_recommend_before_data_raises": "test_torch_bo_api.py::test_recommend_before_data_raises",
    "test_bo.py::test_bo_mixed_space_runs": "test_torch_parallel_bo.py::test_bo_mixed_space_runs_mies",
    "test_bo.py::test_bo_dict_eval_type": "test_torch_bo_api.py::test_bo_dict_eval_type",
    "test_bo.py::test_parallel_bo_q_points": "test_torch_parallel_bo.py::test_sampled_parameters_equal_jax_over_three_asks",
    "test_bo.py::test_parallel_bo_ucb_sampler":
        "test_torch_parallel_bo.py::test_sampled_parameters_equal_jax_over_three_asks",
    "test_bo.py::test_noisy_bo": "test_torch_parallel_bo.py::test_noisy_bo_accepts_duplicates_and_plugs_in_a_prediction",
    "test_bo.py::test_save_load_roundtrip": "test_torch_bo_api.py::test_save_load_roundtrip",
    "test_bo.py::test_infeasible_constraint_ask_empty": "test_torch_bo_api.py::test_infeasible_constraint_ask_empty",
    "test_bo.py::test_structured_state_roundtrip": "test_torch_bo_api.py::test_structured_state_roundtrip",
    "test_bo.py::test_structured_state_space_mismatch": "test_torch_bo_api.py::test_structured_state_space_mismatch",
    "test_bo.py::test_theta_bounds_rescaled_to_unit_embedding":
        "test_torch_bo_api.py::test_theta_bounds_rescaled_to_unit_embedding",
    "test_bo.py::test_bo_with_nonparametric_trend_prior_in_acquisition":
        "test_torch_conditional_bo.py::test_nonparametric_trend_predict_and_refit",
    # tests/test_coco_logger.py
    "test_coco_logger.py::test_files_created": BENCHMARK,
    "test_coco_logger.py::test_info_format": BENCHMARK,
    "test_coco_logger.py::test_dat_lines_monotone_regret": BENCHMARK,
    "test_coco_logger.py::test_tdat_triggers_are_eval_decades": BENCHMARK,
    "test_coco_logger.py::test_measured_fitness_column": BENCHMARK,
    "test_coco_logger.py::test_harness_integration": BENCHMARK,
    # tests/test_constrained_bo.py
    "test_constrained_bo.py::test_bo_equality_bfgs_traced": "test_torch_constrained_bo.py::test_bo_equality_bfgs_traced",
    "test_constrained_bo.py::test_bo_equality_callback_fallback":
        "test_torch_constrained_bo.py::test_bo_equality_callback_fallback",
    "test_constrained_bo.py::test_bo_inequality_rf_dict": "test_torch_constrained_bo.py::test_bo_inequality_dict_mixed_space",
    "test_constrained_bo.py::test_parallel_bo_inequality_batch":
        "test_torch_constrained_bo.py::test_parallel_bo_inequality_batch",
    "test_constrained_bo.py::test_bad_constraint_raises": "test_torch_constrained_bo.py::test_bad_constraint_raises",
    "test_constrained_bo.py::test_unit_to_raw_matches_decode":
        "test_torch_constraints.py::test_unit_to_raw_matches_jax_and_decode",
    "test_constrained_bo.py::test_constraint_program_traced_matches_host":
        "test_torch_constraints.py::test_h_g_penalty_and_gradient_match_jax",
    "test_constrained_bo.py::test_constraint_penalty_gradient_exists":
        "test_torch_constraints.py::test_penalty_gradient_numbers",
    "test_constrained_bo.py::test_select_feasible_prefers_feasible_winner":
        "test_torch_constraints.py::test_select_feasible_matches_jax",
    "test_constrained_bo.py::test_save_load_rebuilds_constraints":
        "test_torch_constrained_bo.py::test_save_load_rebuilds_constraints",
    # tests/test_distributed.py
    "test_distributed.py::test_two_process_initialize_and_collective":
        "test_torch_distributed.py::test_two_process_initialize_and_collective",
    "test_distributed.py::test_harness_shard_split_partitions_tasks": BENCHMARK,
    "test_distributed.py::test_initialize_noop_single_process":
        "test_torch_distributed.py::test_initialize_noop_single_process",
    # tests/test_encoding.py
    "test_encoding.py::test_embed_layout": "test_torch_space_encoding.py::test_embed_layout",
    "test_encoding.py::test_unit_roundtrip_through_raw": "test_torch_space_encoding.py::test_unit_roundtrip_through_raw",
    "test_encoding.py::test_quantize_idempotent": "test_torch_space_encoding.py::test_quantize_idempotent",
    "test_encoding.py::test_embed_is_jittable_and_onehot": "test_torch_space_encoding.py::test_embed_is_onehot",
    "test_encoding.py::test_lhs_unit_sampler": "test_torch_space_encoding.py::test_lhs_unit_sampler",
    "test_encoding.py::test_real_gradients_flow": "test_torch_space_encoding.py::test_real_gradients_flow",
    "test_encoding.py::test_unit_to_embed_np_matches_traced":
        "test_torch_space_encoding.py::test_unit_to_embed_np_matches_tensor",
    # tests/test_extensions.py
    "test_extensions.py::test_linear_transform_roundtrip": "test_torch_extensions.py::test_linear_transform_roundtrip",
    "test_extensions.py::test_linear_transform_weights_favor_good_points":
        "test_torch_pcabo.py::test_linear_transform_weights_favor_good_points",
    "test_extensions.py::test_pcabo_runs_on_ellipsoid": "test_torch_pcabo.py::test_pcabo_runs_on_ellipsoid",
    "test_extensions.py::test_conditional_bo": "test_torch_conditional_bo.py::test_conditional_bo",
    "test_extensions.py::test_multi_acquisition_bo": "test_torch_extensions.py::test_multi_acquisition_bo",
    "test_extensions.py::test_annealing_bo_t_decreases": "test_torch_extensions.py::test_annealing_bo_t_decreases",
    "test_extensions.py::test_self_adaptive_bo": "test_torch_extensions.py::test_self_adaptive_bo",
    "test_extensions.py::test_pcabo_q_gt_1_batched": "test_torch_pcabo.py::test_pcabo_q_gt_1_batched",
    "test_extensions.py::test_pcabo_flags_incumbent_and_warm_start":
        "test_torch_pcabo.py::test_pcabo_flags_incumbent_and_warm_start",
    "test_extensions.py::test_pcabo_flags_off_no_seed": "test_torch_pcabo.py::test_pcabo_flags_off_no_seed",
    # tests/test_gp.py
    "test_gp.py::test_nll_matches_numpy_golden": "test_torch_gp_modes.py::test_nll_matches_numpy_golden",
    "test_gp.py::test_padding_invariance": "test_torch_gp_modes.py::test_padding_invariance",
    "test_gp.py::test_predict_matches_numpy_golden": "test_torch_gp_modes.py::test_predict_matches_numpy_golden",
    "test_gp.py::test_vmapped_lbfgs_minimizes_quadratic": "test_torch_gp_modes.py::test_lbfgs_minimizes_quadratic",
    # its counter sees the objective's traces under jax.disable_jit (2),
    # not its evaluations: both packages replay a converged lane to
    # max_iter (ROADMAP Queue 3, the stall exit)
    "test_gp.py::test_lbfgs_exits_at_line_search_fixed_point":
        "jax-only: JAX jit/HLO internals; see test_torch_gp.py::test_minimize_restarts_lanes_match_jax_in_f64",
    "test_gp.py::test_gp_fit_predict_interpolates": "test_torch_gp_modes.py::test_gp_fit_predict_interpolates",
    "test_gp.py::test_gp_mle_beats_random_theta": "test_torch_gp_modes.py::test_gp_mle_beats_random_theta",
    "test_gp.py::test_gp_multioutput": "test_torch_gp_modes.py::test_gp_multioutput",
    "test_gp.py::test_gp_noise_estim_mode": "test_torch_gp_modes.py::test_gp_noise_estim_mode",
    "test_gp.py::test_gp_gradient_matches_fd": "test_torch_gp_derivatives.py::test_gradient_matches_jax",
    "test_gp.py::test_nonparametric_trend_residual_gp":
        "test_torch_conditional_bo.py::test_nonparametric_trend_criterion_matches_jax",
    "test_gp.py::test_hessian_mean_and_mse_vs_finite_differences":
        "test_torch_gp_derivatives.py::test_hessian_matches_jax",
    "test_gp.py::test_mle_ladder_plan_respects_n": "test_torch_gp_modes.py::test_mle_ladder_plan_respects_n",
    "test_gp.py::test_theta_prior_pulls_away_from_white_noise_basin":
        "test_torch_gp_modes.py::test_theta_prior_pulls_away_from_white_noise_basin",
    "test_gp.py::test_escalate_nugget_contract": "test_torch_gp_modes.py::test_escalate_nugget_contract",
    "test_gp.py::test_gp_f64_likelihood_option": "test_torch_gp_modes.py::test_gp_f64_likelihood_option",
    "test_gp.py::test_gp_cma_mle_path": "test_torch_gp_cma.py::test_fit_no_worse_than_its_best_start",
    # tests/test_hmc.py
    "test_hmc.py::test_hmc_recovers_gaussian_moments": "test_torch_hmc.py::test_hmc_recovers_gaussian_moments",
    "test_hmc.py::test_vi_recovers_gaussian_mean": "test_torch_hmc.py::test_vi_recovers_gaussian_mean",
    "test_hmc.py::test_gp_hmc_fit_predict": "test_torch_gp_hmc.py::test_predict_matches_jax",
    "test_hmc.py::test_bo_with_hmc_gp": "test_torch_bo_hmc.py::test_bo_with_posterior_gp",
    "test_hmc.py::test_unknown_optimizer_raises": "test_torch_gp_cma.py::test_other_samplers_still_raise",
    "test_hmc.py::test_gp_vi_fit_matches_hmc_moments": "test_torch_hmc.py::test_fit_vi_matches_jax",
    "test_hmc.py::test_bo_with_vi_gp": "test_torch_bo_hmc.py::test_bo_with_posterior_gp",
    "test_hmc.py::test_bo_with_nuts_gp": "test_torch_bo_hmc.py::test_bo_with_posterior_gp",
    "test_hmc.py::test_nuts_moments_match_truth_and_hmc": "test_torch_hmc.py::test_nuts_moments_match_truth",
    "test_hmc.py::test_gp_fit_with_nuts_ensemble": "test_torch_gp_hmc.py::test_fit_matches_jax",
    # tests/test_kernels_generic.py
    "test_kernels_generic.py::test_half_integer_matches_bessel":
        "test_torch_kernels_generic.py::test_kernel_matches_jax_float64",
    "test_kernels_generic.py::test_generic_nu_matches_bessel": "test_torch_kernels_generic.py::test_generic_nu_matches_jax",
    "test_kernels_generic.py::test_generic_nu_theta_gradient": "test_torch_kernels_generic.py::test_generic_nu_matches_jax",
    "test_kernels_generic.py::test_kernel_fn_tuple_names": "test_torch_kernels_generic.py::test_kernel_fn_names",
    "test_kernels_generic.py::test_gp_fit_with_half_integer_nu":
        "test_torch_kernels_generic.py::test_likelihood_matches_jax_float64",
    # tests/test_linalg.py
    "test_linalg.py::test_chol_and_inv_matches_numpy": "test_torch_gp_derivatives.py::test_chol_and_inv_matches_jax_float64",
    "test_linalg.py::test_chol_and_inv_kernel_like": "test_torch_gp_derivatives.py::test_chol_and_inv_float32",
    "test_linalg.py::test_tri_solves": "test_torch_linalg.py::test_upper_t_solves_match_f64",
    "test_linalg.py::test_whiten_value_and_grad": "test_torch_linalg.py::test_whiten_value_and_grad_match_jax",
    "test_linalg.py::test_vmap_batch": "test_torch_linalg.py::test_whiten_batched_lanes_are_independent",
    "test_linalg.py::test_min_pivot_flags_indefinite": "test_torch_linalg.py::test_whiten_flags_indefinite_like_jax",
    "test_linalg.py::test_factor_hybrid_matches_numpy": "test_torch_linalg.py::test_factor_hybrid_matches_jax_and_f64",
    "test_linalg.py::test_super_solves_match_blocked": "test_torch_linalg.py::test_upper_t_solves_match_f64",
    # tests/test_mo.py
    "test_mo.py::test_is_non_dominated": "test_torch_mo.py::test_is_non_dominated",
    "test_mo.py::test_fast_non_dominated_sort": "test_torch_mo.py::test_fast_non_dominated_sort",
    "test_mo.py::test_hypervolume_2d_golden": "test_torch_mo.py::test_hypervolume_goldens",
    "test_mo.py::test_hypervolume_3d_golden": "test_torch_mo.py::test_hypervolume_goldens",
    "test_mo.py::test_hypervolume_point_below_ref_ignored": "test_torch_mo.py::test_hypervolume_goldens",
    "test_mo.py::test_partitioning_covers_complement": "test_torch_mo.py::test_partitioning_covers_complement",
    "test_mo.py::test_partitioning_3d_complement": "test_torch_mo.py::test_partitioning_cells_equal_jax_in_order",
    "test_mo.py::test_slab_cells_match_grid_golden": "test_torch_mo.py::test_slab_cells_match_grid_golden",
    "test_mo.py::test_slab_cells_polynomial_count_m3": "test_torch_mo.py::test_slab_cells_polynomial_count_m3",
    "test_mo.py::test_ehvi_matches_mc": "test_torch_mo.py::test_qehvi_q1_close_to_ehvi_and_ehvi_matches_mc",
    "test_mo.py::test_qehvi_q1_close_to_ehvi": "test_torch_mo.py::test_qehvi_q1_close_to_ehvi_and_ehvi_matches_mc",
    "test_mo.py::test_mobo_runs_and_improves_hv": "test_torch_mobo.py::test_mobo_runs_and_improves_hv",
    "test_mo.py::test_mobo_q_gt_1_raises": "test_torch_mobo.py::test_mobo_q_gt_1_raises",
    "test_mo.py::test_mobo_recommend_before_data": "test_torch_mobo.py::test_mobo_recommend_before_data",
    "test_mo.py::test_mobo_qehvi_batch": "test_torch_mobo.py::test_mobo_qehvi_batch",
    "test_mo.py::test_mobo_3_objectives": "test_torch_mobo.py::test_mobo_3_objectives",
    "test_mo.py::test_mobo_with_rf_surrogate": "test_torch_mobo.py::test_mobo_with_rf_surrogate",
    "test_mo.py::test_rf_multioutput_predict_shapes": "test_torch_mobo.py::test_rf_multioutput_predict_shapes",
    "test_mo.py::test_mobo_qehvi_3_objectives": "test_torch_mobo.py::test_mobo_qehvi_3_objectives",
    "test_mo.py::test_qehvi_mc_accuracy": "test_torch_mo.py::test_qehvi_mc_accuracy",
    "test_mo.py::test_mobo_constrained_asks_feasible": "test_torch_mobo.py::test_mobo_constrained_asks_feasible",
    "test_mo.py::test_mobo_qehvi_constrained_joint": "test_torch_mobo.py::test_mobo_qehvi_constrained_joint",
    # tests/test_native.py
    "test_native.py::test_wfg_matches_2d_sweep": "test_torch_native.py::test_wfg_matches_2d_sweep",
    "test_native.py::test_wfg_matches_grid": "test_torch_native.py::test_wfg_matches_grid",
    "test_native.py::test_wfg_handles_dominated_and_below_ref":
        "test_torch_native.py::test_wfg_handles_dominated_and_below_ref",
    "test_native.py::test_dispatcher_uses_native_for_large_fronts":
        "test_torch_native.py::test_dispatcher_uses_native_for_large_fronts",
    # tests/test_optim.py
    "test_optim.py::test_run_cma_sphere": "test_torch_cma.py::test_run_cma_sphere",
    "test_optim.py::test_run_cma_ellipsoid_conditioning": "test_torch_cma.py::test_run_cma_ellipsoid_conditioning",
    "test_optim.py::test_cma_class_host_objective": "test_torch_cma.py::test_cma_class_host_objective",
    "test_optim.py::test_cma_class_with_constraint": "test_torch_cma.py::test_cma_class_with_constraint",
    "test_optim.py::test_run_mies_mixed_unit": "test_torch_mies.py::test_run_mies_mixed_unit",
    "test_optim.py::test_mies_class_host_mixed": "test_torch_mies.py::test_mies_class_host_mixed",
    "test_optim.py::test_mies_stops_on_max_eval": "test_torch_mies.py::test_mies_stops_on_max_eval",
    "test_optim.py::test_argmax_x0_seed_injection": "test_torch_argmax_engines.py::test_argmax_x0_seed_injection",
    # tests/test_pallas.py
    "test_pallas.py::test_pallas_matern_matches_xla_sym": PALLAS_MATERN,
    "test_pallas.py::test_pallas_matern_cross": PALLAS_MATERN,
    "test_pallas.py::test_pallas_rbf": PALLAS_MATERN,
    "test_pallas.py::test_whiten_fused_matches_xla_and_f64":
        "jax-only: Pallas interpret mode; see test_torch_hopper_kernels.py::test_whiten_plain_matches_pallas_and_f64, "
        "test_torch_cuda_kernels.py::test_whiten_kernel_matches_twin",
    "test_pallas.py::test_whiten_fused_flags_indefinite":
        "jax-only: Pallas interpret mode; see test_torch_hopper_kernels.py::"
        "test_whiten_plain_flags_indefinite_and_keeps_r, test_torch_cuda_kernels.py::test_whiten_kernel_flags_indefinite",
    "test_pallas.py::test_whiten_fused_aliasing_preserves_caller_r":
        "jax-only: Pallas interpret mode; see test_torch_hopper_kernels.py::"
        "test_whiten_plain_flags_indefinite_and_keeps_r, test_torch_cuda_kernels.py::test_whiten_kernel_matches_twin",
    # tests/test_parallel.py
    "test_parallel.py::test_mesh_has_8_devices": "test_torch_parallel.py::test_mesh_has_8_entries",
    "test_parallel.py::test_shard_population_pads_and_places": "test_torch_parallel.py::test_shard_population_pads_and_places",
    "test_parallel.py::test_sharded_reduction_matches_single_device":
        "test_torch_parallel.py::test_sharded_argmin_matches_single_device",
    "test_parallel.py::test_bo_with_mesh_runs_and_matches_types":
        "test_torch_parallel.py::test_bo_with_mesh_runs_and_matches_types",
    "test_parallel.py::test_graft_entry_dryrun": "test_torch_entry.py::test_dryrun_multidevice_on_8_cpu_entries",
    "test_parallel.py::test_sharded_cma_argmax_loop_has_no_collectives":
        "jax-only: JAX jit/HLO internals; see test_torch_parallel.py::test_argmax_gathers",
    # tests/test_parity_smoke.py
    "test_parity_smoke.py::test_config1_fmin_sphere_within_recorded_band": BENCHMARK,
    "test_parity_smoke.py::test_config2a_bo_ucb_5d_beats_reference_floor": BENCHMARK,
    # tests/test_random_forest.py
    "test_random_forest.py::test_rf_jax_traversal_matches_sklearn":
        "test_torch_random_forest.py::test_traversal_of_a_carried_jax_forest",
    "test_random_forest.py::test_rf_mse_is_tree_variance":
        "test_torch_random_forest.py::test_mse_is_tree_variance_and_seed_fixes_the_forest",
    "test_random_forest.py::test_rf_categorical_levels": "test_torch_random_forest.py::test_rf_categorical_levels",
    "test_random_forest.py::test_surrogate_aggregation": "test_torch_random_forest.py::test_surrogate_aggregation",
    "test_random_forest.py::test_bo_with_rf_surrogate_mixed": "test_torch_conditional_bo.py::test_bo_with_rf_surrogate_mixed",
    # tests/test_ref_golden.py
    "test_ref_golden.py::test_likelihood_value_matches_reference": GOLDENS,
    "test_ref_golden.py::test_fit_quality_on_reference_likelihood": GOLDENS,
    "test_ref_golden.py::test_posterior_moments_match_reference_at_pinned_theta": GOLDENS,
    "test_ref_golden.py::test_cma_fit_quality_on_reference_likelihood": GOLDENS,
    # tests/test_search_space.py
    **{f"test_search_space.py::{name}": f"test_torch_search_space.py::{name}" for name in (
        "test_real_scale_transforms", "test_real_precision_round", "test_bounds_clip_warning",
        "test_space_construction_and_masks", "test_space_algebra", "test_narrowing_classes",
        "test_sampling_methods", "test_lhs_stratification", "test_sample_reproducible_with_seed",
        "test_no_global_rng_mutation", "test_json_roundtrip", "test_subset_powerset",
        "test_conditional_structure", "test_contains_and_getitem", "test_update_and_filter",
        "test_constrained_sampling_scmc", "test_constrained_sampling_equality",
        "test_scmc_auto_vectorized_constraints")},
    # tests/test_service.py
    **{f"test_service.py::{name}": f"test_torch_service.py::{name}" for name in (
        "test_full_protocol_roundtrip", "test_unknown_job_404", "test_bad_post_400", "test_health_endpoint",
        "test_dashboard_html", "test_status_endpoint")},
    # tests/test_smc.py
    "test_smc.py::test_systematic_resample_matches_weights": "test_torch_smc.py::test_systematic_resample_given_jax_offset",
    "test_smc.py::test_resample_chains_multiplies_best": "test_torch_smc.py::test_resample_chains_with_ties_and_inf",
    "test_smc.py::test_run_smc_finds_global_optimum_multimodal":
        "test_torch_smc.py::test_run_smc_finds_global_optimum_multimodal",
    "test_smc.py::test_bo_with_smc_engine": "test_torch_smc.py::test_bo_with_smc_engine",
    "test_smc.py::test_parallelbo_q4_with_smc_engine": "test_torch_smc.py::test_parallelbo_q4_with_smc_engine",
    # tests/test_solution_warmdata.py
    **{f"test_solution_warmdata.py::{name}": f"test_torch_solution_warmdata.py::{name}" for name in (
        "test_slicing_and_metadata", "test_fitness_writes_through_basic_slices", "test_concat_and_repeat",
        "test_unique", "test_dict_roundtrip", "test_csv_roundtrip", "test_warm_data_seeds_model_and_counts",
        "test_warm_data_out_of_space_rejected")},
}


def defined_tests(path: Path) -> list:
    """The test functions of a file: top-level test_* functions and the
    test_* methods of its classes ("Class::method")."""
    out = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name.startswith("test"):
            out.append(node.name)
        elif isinstance(node, ast.ClassDef):
            out += [f"{node.name}::{m.name}" for m in node.body
                    if isinstance(m, ast.FunctionDef) and m.name.startswith("test")]
    return out


def jax_test_files() -> list:
    return sorted(p for p in TESTS.glob("test_*.py") if not p.name.startswith("test_torch_"))


def test_every_jax_test_is_mapped():
    jax_tests = [f"{p.name}::{name}" for p in jax_test_files() for name in defined_tests(p)]
    assert len(jax_tests) >= 210
    missing = [t for t in jax_tests if t not in REFERENCE_MAP]
    assert not missing, f"JAX tests with no entry: {missing}"
    stale = sorted(set(REFERENCE_MAP) - set(jax_tests))
    assert not stale, f"entries for JAX tests that no longer exist: {stale}"


def test_every_entry_names_a_port_test_or_a_listed_reason():
    port = {p.name: set(defined_tests(p)) for p in TESTS.glob("test_torch_*.py")}
    for jax_test, entry in REFERENCE_MAP.items():
        if entry.startswith("jax-only: "):
            reason = entry[len("jax-only: "):].split(";")[0]
            assert reason in REASONS, (jax_test, reason)
        else:
            assert "::" in entry and "jax-only" not in entry, (jax_test, entry)
        for file, name in re.findall(r"(test_torch_\w+\.py)::(\w+)", entry):
            assert name in port.get(file, ()), (jax_test, f"{file}::{name}")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of bayesian_optimization_tpu_torch (tools/ aside: scripts
    run on the card) imports in a process where `import jax` and `import
    bayesian_optimization_tpu` fail."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['bayesian_optimization_tpu'] = None\n"
        "import bayesian_optimization_tpu_torch as pkg\n"
        "names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')\n"
        "               if not m.name.startswith(pkg.__name__ + '.tools'))\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 50
