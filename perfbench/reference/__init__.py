"""The benchmark's yardstick: plain references, the numbers compared, and
the frozen counts and peaks.  Nothing here imports the program."""
