"""fustpu — matrix-free spectral-element solver for focused ultrasound
(FUS) wave propagation, in JAX.

A ground-up JAX/XLA re-design of the capabilities of
``adeebkor/fenicsx-fus-gpu`` (mounted read-only at /root/reference):

- GLL spectral hex elements (degree P=2..10) with collocated GLL quadrature
  (diagonal mass matrix), tensor-product DOF ordering.
- Sum-factorised matrix-free mass / stiffness / boundary-facet-mass operator
  application, batched over cells.
- Linear second-order wave equation and the nonlinear Westervelt equation
  with windowed velocity sources and first-order absorbing boundaries.
- Explicit RK4 time integration fully on device under ``jax.lax.scan``.
- Multi-chip domain decomposition via ``jax.sharding.Mesh`` + ``shard_map``
  with halo exchange by ``lax.ppermute`` instead of MPI; multi-host
  process groups via ``jax.distributed`` (fustpu.parallel.multihost).
- Unstructured conforming hex meshes imported from tagged Gmsh ``.msh``
  files, ASCII or binary (fustpu.mesh.unstructured / msh_io).  Prismatic
  meshes (extrusions along any axis — every practical piston/column/
  bowl-fitted mesh) auto-detect and run a factorized fast path at
  ~structured speed (fustpu.mesh.extruded); anything else uses the
  explicit-dofmap indexed path.  Both shard over any device count
  (fustpu.parallel.extruded.shard_unstructured).

Unlike the reference (CUDA thread-per-dof kernels + atomics + MPI halo
exchange), assembly on structured box meshes is deterministic: the global
scatter-add is a closed-form separable "overlap add" (reshape+pad+add per
axis, no scatter at all).  On general index maps it is an XLA scatter-add,
which on a GPU sums with atomics in no fixed order.
"""

__version__ = "0.1.0"

from fustpu import config as config
from fustpu.config import Material, Source
from fustpu.elements import gll as gll
from fustpu.mesh.box import BoxMesh, build_box_mesh
from fustpu.models.linear import LinearWaveModel
from fustpu.models.westervelt import WesterveltModel
from fustpu.parallel.models import ShardedModel
from fustpu.parallel.sharding import DeviceGrid
from fustpu.mesh.msh_io import read_msh, write_msh
from fustpu.mesh.unstructured import UnstructuredHexMesh
from fustpu.mesh.extruded import ExtrudedHexMesh, as_extruded
from fustpu.parallel.extruded import (ExtrudedShardedModel,
                                      IndexedShardedModel,
                                      shard_unstructured)
from fustpu.mesh.xdmf_io import read_xdmf, xdmf_to_msh
