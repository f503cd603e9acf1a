"""Problem models: board geometry and the Sudoku CSP."""
