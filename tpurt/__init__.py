"""tpurt — a hybrid real-time ray-traced renderer in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
EdoardoLuciani/ARayTracingJourney (Vulkan ray tracing, Rust host):
PBR pipeline, ray-traced shadows, point/spot/directional/area lights,
XeGTAO ambient occlusion, FidelityFX-LPM HDR tonemapping, glTF input.

Layer map (analogue of the reference's L0-L8):
  scene/    asset I/O + scene state      (reference: model_reader/, vk_model.rs,
                                          vk_camera.rs, lights.rs)
  bvh/      acceleration structures      (reference: vk_blas_builder.rs,
                                          vk_tlas_builder.rs — hardware BVH)
  kernels/  ray traversal + intersection (reference: traceRayEXT hardware)
  passes/   shading / GTAO / tonemap     (reference: shaders/)
  engine/   frame orchestration          (reference: renderer.rs)
  dist/     multi-device sharding        (no reference counterpart: single-GPU)
  native/   C++ host-side asset kernels  (reference: SIMD pixel permute etc.)
"""

__version__ = "0.1.0"
