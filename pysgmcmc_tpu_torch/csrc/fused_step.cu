// The fused kernels B1-B6 with Box-Muller normals (fused_body.cuh holds the
// body and its design notes): the library of ops/fused_step.py's wrappers
// for noise_impl="box_muller", and the placement rule of all three variants.

#define FUSED_STEP_VARIANT 0  // kBoxMuller
#include "fused_body.cuh"

extern "C" {

#if FUSED_PART_HAS(0)
// Shared memory one block of kernel `kernel` (a KernelId) needs with the
// chain's state resident, in bytes: the placement rule.  Above a block's
// limit the wrapper passes a device-memory workspace instead.  The CLT and
// paired variants need the same.
unsigned long long fused_step_smem_bytes(int kernel, int n_params,
                                         int n_inputs, int hidden, int depth,
                                         int batch) {
  return smem_bytes(rule_of(kernel), burnin_of(kernel), n_params, n_inputs,
                    hidden, depth, batch, true);
}

// Floats of one chain's slice of the device-memory workspace.
unsigned long long fused_step_workspace_floats(int kernel, int n_params) {
  return static_cast<unsigned long long>(
             state_arrays(rule_of(kernel), burnin_of(kernel))) * n_params;
}

const char* fused_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B1: k SGHMC sampling steps with a frozen minv.
FUSED_STEP_ENTRY(fused_bnn_multistep_launch, kSghmc, false, false)
// B2: k SGHMC self-tuning burn-in steps; minv_out gets the final step's minv.
FUSED_STEP_ENTRY(fused_bnn_multistep_burnin_launch, kSghmc, true, false)
// B3: one SGHMC sampling step on each chain's gathered rows.
FUSED_STEP_ENTRY(fused_bnn_step_launch, kSghmc, false, true)
#endif

#if FUSED_PART_HAS(1)
// B4-sgld: one SGLD sampling step on each chain's gathered rows.
FUSED_STEP_ENTRY(fused_bnn_step_sgld_launch, kSgld, false, true)
// B5-sgld: k SGLD sampling steps with a frozen minv.
FUSED_STEP_ENTRY(fused_bnn_multistep_sgld_launch, kSgld, false, false)
// B6: k SGLD burn-in steps; minv_out gets the final step's minv.
FUSED_STEP_ENTRY(fused_bnn_multistep_burnin_sgld_launch, kSgld, true, false)
// B4-psgld: one pSGLD step on each chain's gathered rows; v_out gets the new
// accumulator.
FUSED_STEP_ENTRY(fused_bnn_step_psgld_launch, kPsgld, false, true)
// B5-psgld: k pSGLD steps.
FUSED_STEP_ENTRY(fused_bnn_multistep_psgld_launch, kPsgld, false, false)
#endif

#if FUSED_PART_HAS(2)
// B4-sgnht: one SGNHT step on each chain's gathered rows; v_out and xi_out
// get the new momentum and thermostat.
FUSED_STEP_ENTRY(fused_bnn_step_sgnht_launch, kSgnht, false, true)
// B4-rsghmc: one relativistic SGHMC step on each chain's gathered rows.
FUSED_STEP_ENTRY(fused_bnn_step_rsghmc_launch, kRsghmc, false, true)
// B5-sgnht: k SGNHT steps, the thermostat moving after each.
FUSED_STEP_ENTRY(fused_bnn_multistep_sgnht_launch, kSgnht, false, false)
// B5-rsghmc: k relativistic SGHMC steps.
FUSED_STEP_ENTRY(fused_bnn_multistep_rsghmc_launch, kRsghmc, false, false)
#endif

}  // extern "C"
