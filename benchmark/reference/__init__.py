"""Plain references the benchmark judges the program's outputs against."""
