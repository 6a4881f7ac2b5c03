"""Hand-written CUDA kernels of the port, built for sm_90a at first use.

Each wrapper module holds a plain integer launch count and sends a CUDA
tensor to its kernel (or raises) and a CPU tensor to its plain PyTorch
twin; nothing else chooses between them. (The flow smoother's fused
entries take CUDA tensors only: ``ops/flow.py flow_level`` and
``ema_tail`` choose between them and their twins.) ``_build`` compiles
``video3d_tpu_torch/csrc/*.cu`` with nvcc into ``build/kernels/`` and loads
the library with ctypes. ``sgm_aggregate_pallas`` (B8a) is exported here,
as the JAX package exports its kernel of that name.

Every TPU kernel of the JAX package (each function reaching
``pl.pallas_call``) and where it stands in the port:

==== ======================================================= ===============================
 #    TPU kernel (video3d_tpu/...)                            port
==== ======================================================= ===============================
 B1   kernels/costvol.py:394 fused_cost_volume                csrc/costvol.cu, kernels/costvol.py
                                                              (redesigned: a block walks a strip
                                                              of columns down the rows, each raw
                                                              cost once, a running vertical sum)
 B1-  same, VIDEO3D_TPU_COSTVOL_NATIVE_I16=1                  csrc/costvol.cu (the same kernel:
 i16  (_cost_row_step_i16 :196)                               it computes in int16 at 2x scale,
                                                              bit-equal to that variant)
 B2   kernels/sgm.py:617 _directional_pass_dmajor             csrc/sgm.cu, kernels/sgm.py
                                                              (int16 or f32 accumulator;
                                                              redesigned: both directions of a
                                                              row in one launch, from its two
                                                              ends, rows sharing a warp)
 B3   kernels/sgm.py:882 sgm_wta_pallas_dmajor                csrc/sgm.cu, kernels/sgm.py
                                                              (redesigned: every direction of a
                                                              sweep step in one cooperative
                                                              launch, the WTA in the closing
                                                              launch on the total in registers)
 B4   kernels/speckle.py:159 speckle_filter_pallas            csrc/speckle.cu, kernels/speckle.py
                                                              (redesigned: one kernel, the
                                                              window counted by running sums)
 B5   kernels/warp.py:91 warp_bilinear_shifts_pallas          csrc/warp.cu, kernels/warp.py
                                                              (redesigned: also the smoother's
                                                              full-resolution EMA step, the flow
                                                              upsampled inside, in two or three
                                                              launches)
 B6   kernels/flowmatch.py:122 flow_match_pallas              csrc/flowmatch.cu, kernels/flowmatch.py
                                                              (redesigned: one launch per level
                                                              step, the upsample and the warp
                                                              inside)
 B7a  kernels/attention.py:84 attention_multihead             csrc/attention.cu, kernels/attention.py
 B7b  kernels/attention.py:116 attention_oneblock             csrc/attention.cu, kernels/attention.py
                                                              (redesigned: one kernel and one
                                                              launch for both, no head loop, as
                                                              heads_per_step is a TPU grouping;
                                                              bf16 on wgmma with TMA-fed K/V
                                                              tiles, f32 on the CUDA cores; one
                                                              launch count)
 B8a  kernels/sgm.py:119 _directional_pass                    csrc/sgm.cu, kernels/sgm.py
      (via sgm_aggregate_pallas :148)                         sgm_aggregate_pallas (redesigned:
                                                              B2's and B3's kernels on an f32 or
                                                              bf16 cost, the horizontal pair in
                                                              one launch and one launch per
                                                              vertical sweep step storing the
                                                              f32 total: 3 launches at 8 paths)
 B8b  kernels/sgm.py:254,279 transpose_to/from_wmajor         csrc/wmajor.cu, kernels/wmajor.py
                                                              (redesigned: one persistent launch a
                                                              way, 64-row by 256-byte tiles through
                                                              a swizzled cp.async ring, 16-byte
                                                              accesses on both sides)
 B8c  kernels/sgm.py:391 _directional_pass_wmajor             csrc/wmajor.cu, kernels/wmajor.py
 P    tools/probe_i16.py:34 run (toy kernels :50-70)          csrc/probe_i16.cu,
                                                              tools/probe_i16.py (a toolchain
                                                              probe, outside the stage;
                                                              redesigned: the six ops in one
                                                              launch, probe_all)
==== ======================================================= ===============================

``sgm_aggregate_pallas_dmajor`` (kernels/sgm.py:1018) only calls B2; the
port's is a wrapper around B8a's.

Kernels of the port that replace no TPU kernel: I1 (``csrc/image.cu``,
``image.py``: the eyes' split, unsqueeze and gray, a dense product in the
JAX stage) F1, F2 (``csrc/blend.cu``, ``blend.py``: the hole fill and the
confidence-trust blend after the guide, plain jnp in the JAX package) and
A1 (``csrc/agcl.cu``, ``agcl.py``: the published CREStereo's adaptive group
correlation, which the JAX package does not have).
"""

from video3d_tpu_torch.kernels.sgm import sgm_aggregate_pallas

__all__ = ["sgm_aggregate_pallas"]
