"""Distribution planning: meshes, placements, input stand-ins, the dry run
and its roofline (the port of ``repro.launch``; see each module)."""
