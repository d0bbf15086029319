"""PyTorch/CUDA port of ``repro``, the JAX reference package.

The port mirrors the reference's module paths (``repro_torch.models.attention``
is the counterpart of ``repro.models.attention``) and never imports JAX or the
reference package. Entry points run on the CUDA card unless the caller passes
``device="cpu"``; see ``repro_torch.device``.

In the simulated path (``core``, ``sim``, ``fleet``) ``device`` keeps the
reference's meaning, the simulated accelerator's profile (``"a100"``), and
the torch device is ``torch_device``: a keyword of ``core.PowerModel`` and of
every public function that runs tensors itself (``sim.energy_report``,
``core.microgrid.simulate``, ``core.run_cosim``,
``fleet.run_fleet_simulation``, ``ExecutionModel.stage_cost_batch`` with
``backend="torch"``). Functions handed a ``PowerModel`` (Eqs. 2-5 in
``core``) evaluate Eq. 1 where it says. ``None`` means the card; without
one they raise. Config dataclasses never carry a torch device.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
