"""Launch-side helpers: the rank meshes distributed transforms run on."""
