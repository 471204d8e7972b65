"""Plain float32 references the benchmark judges the program against; they import nothing of the program."""
