"""Window drivers, one a kind of path; a traffic file names its driver."""
