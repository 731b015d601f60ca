"""Each kernel function's work, counted from the function at a cell's shapes."""
