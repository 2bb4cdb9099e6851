# Hand-written CUDA kernels of the port (built by kernels/build.py):
#   engine_step   — fused signals + policy update, and the padded-gather
#                   segment reduction (+ fused PFC hysteresis): the
#                   simulator's per-step hot loop (see repro_torch.core.engine
#                   step_impl="cuda").
#   cc_update     — the DCQCN per-flow update behind the reference's entry
#                   point dcqcn_update; shares the policy device functions
#                   (csrc/cc_policy.cuh) with the fused step kernel.
#   embedding_bag — multi-hot sum pooling of the DLRM forward (see
#                   repro_torch.models.dlrm embedding_impl="cuda").
#   flash_decode  — one-token GQA attention over a KV cache, the serving
#                   path's decode attention (see repro_torch.models.model_api
#                   decode_impl="cuda").
# Each has ops.py (wrapper: kernel on CUDA tensors, plain version on CPU
# tensors), ref.py (the plain PyTorch versions) and csrc/ (CUDA C++).
