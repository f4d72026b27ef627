"""Dense linear-algebra layer: batched helpers, the Gauss-Jordan inverse
kernel, SPD inverses, double-word f32 arithmetic and CSC ingestion."""
