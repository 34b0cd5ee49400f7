"""Feed entries, one module a name: a traffic mix's ``feed`` names the
module whose ``Entry`` turns the stream's batches into the program's input
and calls the program with it."""
