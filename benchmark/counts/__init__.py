"""Work counts of the radiation call's stages, from shapes alone."""
