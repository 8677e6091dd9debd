"""PyTorch/CUDA port of the HFL planner (the JAX package ``repro`` is the
reference).

Same layout and public names as ``repro``: :mod:`repro_torch.core` (scenario
model, cost model, SROA), :mod:`repro_torch.fleet` (batched SROA, the
assignment engine, dynamics, the planner, rolling horizons, topology
design and the streaming service), :mod:`repro_torch.fed` (the upload
compression ladder and uplink transforms, Algorithm 1 batched over users,
straggler deadlines, Algorithm 1 over LM pods in ``fed.hfl_lm``),
:mod:`repro_torch.data` (synthetic datasets and federated partitions),
:mod:`repro_torch.models` (the paper's CNNs and every family of the
transformer zoo, with its loss and train step), :mod:`repro_torch.optim`
(functional optimizers and schedules), :mod:`repro_torch.ckpt` (checkpoints in the JAX
package's format), :mod:`repro_torch.runtime` (failure detection and
recovery), :mod:`repro_torch.kernels` (the hand-written Hopper kernels and
their plain PyTorch versions) and :mod:`repro_torch.launch` (the ``serve``
and ``train`` entry points).

Every entry point takes an explicit ``device=`` (default ``"cuda"``); the CPU
is used only when asked for, and then every kernel wrapper runs its plain
PyTorch version.
"""
