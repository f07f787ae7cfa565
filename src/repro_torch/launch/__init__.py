"""Launch-side entry points: the rank meshes distributed transforms run
on, and the LM serving engine."""
