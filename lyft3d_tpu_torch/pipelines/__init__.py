"""End-to-end pipelines of the port: BEV inference."""
