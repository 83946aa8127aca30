"""The plain reference that decides a run's `correct`.

Plain torch and numpy, written from the renderer's published shader
formulas: it imports neither JAX nor raytracer2_tpu nor anything of
raytracer2_tpu_torch, and works out from the scene's GLB bytes whatever it
needs (world-space triangles, materials, linear textures). Every function
takes a `dtype`: the limits' controls run it one precision below the
program's float32.
"""
