"""raytracer — a JAX-native differentiable ray tracer for the GPU.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the reference
CUDA renderer ``wtzhang23/gpu-ray-tracer`` (see SURVEY.md): procedurally generated
cube worlds from ``world*.json`` configs, Whitted-style recursive reflection and
refraction, Phong shading with transmissive shadow rays, instance-level
acceleration structures, plus what the reference lacks — differentiability and
multi-chip scaling via ``jax.sharding``.
"""

from .scene import Camera, Lights, Materials, RenderConfig, Scene
from .builder import Material, SceneBuilder, TextureCoords
from .cube_world import GeneratedWorld, generate

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "GeneratedWorld",
    "Lights",
    "Material",
    "Materials",
    "RenderConfig",
    "Scene",
    "SceneBuilder",
    "TextureCoords",
    "generate",
    "__version__",
]
