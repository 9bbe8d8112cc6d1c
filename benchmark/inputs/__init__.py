"""The benchmark's own input generators: frozen copies of the program's."""
