"""Dense linear-algebra layer: batched helpers, the Gauss-Jordan inverse
kernel, SPD inverses and double-word f32 arithmetic."""
