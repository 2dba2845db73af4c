"""ipu_ray_lib_tpu: a JAX ray/path-tracing framework for NVIDIA GPUs.

A ground-up JAX/XLA re-design of the capabilities of the reference
IPU ray tracing library (``markp-gc/ipu_ray_lib``): path tracing and shadow
tracing of triangle meshes / spheres / discs with a compact fp16-extent BVH,
a neural-image-field (NIF) HDRI environment light, CPU-twin verification
renderers, and data-parallel scale-out over device meshes.

Key design translations (reference -> JAX):

* AoS ``TraceResult`` byte streams + serialiser  ->  SoA JAX arrays
  (a :class:`~ipu_ray_lib_tpu.scene.build.SceneArrays` pytree).
* Per-ray stack-based BVH traversal (ref ``include/CompactBvh.hpp``)  ->
  stackless threaded-BVH traversal (miss links) with uniform control flow
  batched over rays under ``jax.lax.while_loop``.
* Divergent path-trace codelet (ref ``codelets/TraceCodelets.cpp``)  ->
  streaming wavefront loop with masked lanes and path regeneration.
* Replicated Poplar graphs over IPUs  ->  ``shard_map`` data parallelism
  over a ``jax.sharding.Mesh``.
"""

__version__ = "0.1.0"
