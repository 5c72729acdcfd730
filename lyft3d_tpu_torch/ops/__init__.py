"""Device ops of the BEV slice: raster, connected components, box extraction."""
